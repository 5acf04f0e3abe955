#!/usr/bin/env python3
"""On-card smoke of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --tile-sweep [--out sweep.json]
    python3 chip_smoke.py --mttkrp-sweep [--out sweep.json]
    python3 chip_smoke.py --tc-sweep [--out sweep.json]
    python3 chip_smoke.py --skinny-sweep [--out sweep.json]
    python3 chip_smoke.py --fft-sweep [--out sweep.json]
    python3 chip_smoke.py --conv2d-sweep [--src OTHER/src] [--out sweep.json]
    python3 chip_smoke.py --fir-sweep [--src OTHER/src] [--out sweep.json]
    python3 chip_smoke.py --train
    python3 chip_smoke.py --dense
    python3 chip_smoke.py --hier
    python3 chip_smoke.py --systolic
    python3 chip_smoke.py --mesh
    python3 chip_smoke.py --dryrun [--out DIR]

Needs one CUDA card and the CUDA toolkit.  It imports only the port, never
JAX nor the JAX package, and runs twenty-two phases, each printing its own
line(s); any failure exits non-zero:

1. device — the card's name and power limit, torch and CUDA versions;
2. build  — compiles the port's four CUDA sources from ``src/`` (one
   ``nvcc`` each, started together; set-up time);
3. kernels — every hand-written kernel against its plain PyTorch version
   on the card: the mm/bmm GEMMs in all five dtypes at every serving
   shape and at ragged ones on the kernel the runtime picks (the skinny
   kernel for A of at most 16 rows, the tensor-core ones above, fed by
   TMA or, for a float operand TMA cannot address, by cp.async, the tiled
   one for rows that allow no 4-byte copy), the tensor-core kernels at every
   qwen prefill GEMM of 17, 64, 127 and 512 tokens, quickstart's 1024^3
   and ragged shapes in bf16 -> bf16, bf16 -> fp32, float32 and int8,
   int16 and int32 -> int32 with both B layouts (and a one-TF32 control
   that float32's atol must reject), the skinny
   kernel at every M up to 16 with both B layouts and K split unevenly
   over a cluster, a misaligned B (routed to the tiled kernel where its
   rows do not allow 4-byte copies), every compiled tile of the tiled
   kernel, the bf16 -> fp32 bmm, and two runs of split-K float products
   bitwise equal; the skinny kernel's long sums (``skinny_long_sums``:
   qwen3-32b's down projection, K = 25600, against the float64 sum
   beside the plain version's fp32 sum); FIR and conv2d in every dtype they take, at the
   whisper-base frontend shapes and at ragged ones, FIR on the
   instantiation of its tap count (15) and on the generic one (which
   alone takes 1, 7, 16, 64 and 4096 taps), ``fir_complex`` at the same
   shapes in one launch a call, and FIR of an x that starts 1-3 elements
   into its storage, conv2d on the compiled window the runtime picks (4 x 4,
   8 x 8, 5 x 4) and on the generic instantiation (which alone takes 1 x
   1, 3 x 5, 12 x 7 and 32 x 32); the fused fft2d kernel at
   ``FFT_SHAPES`` (two runs bitwise equal) and the composition over the
   GEMMs at the frontend tile against ``torch.fft.fft2``; the FFT kernel
   (``fft_pass_kernel``, the grids above 64 rows) at ``FFT_KERNEL_SHAPES``
   on the runtime's tile and at 8192^2 on the portable cluster of 8, against its
   plain version (``fft2d.fft_plain``, bitwise) and ``torch.fft.fft2``
   (``fft_parity``).  Then each is
   timed beside its plain
   version, one PyTorch call computing the same function
   (``torch.matmul``/``torch.bmm``, ``F.conv1d``, ``F.conv2d``,
   ``torch.fft.fft2``: yardsticks only) and its memory/compute bound, at
   the main-path shapes and, for FIR and conv2d, at the registry's
   bandwidth-sized bench cases (the paper's FIR table: 1048576 outputs of
   15 taps in float32, int8, int16 and cfloat, the last as the pipeline
   runs it, one real launch on float32 planes, and ``fir_complex`` in
   float32 beside one two-channel ``F.conv1d`` and the four real ones;
   the paper's conv2d table: 10240^2 outputs, float32, int16 and int32 by
   4 x 4, int8 by 8 x 8), each beside a ``copy_`` of the same bytes.  The GEMMs (every qwen serving shape and
   whisper-base's lm_head) get ``torch.profiler`` device time of the
   skinny kernel, of the tiled kernel at the tile the plan maps to and of
   the library call, the weight GEMMs over a rotation of distinct B operands
   of ``COLD_BYTES`` so that B comes from HBM as in a decode step, and
   the host time of a wrapper call and of a planned-facade call (with a
   ``cProfile`` breakdown at one shape); the prefill GEMMs of a 512-token
   prompt and quickstart's float32 1024^3 the same for the tensor-core
   kernel, the tiled kernel and the library call; FIR, conv2d, the fused
   fft2d kernel (the composition's device time beside it, at the
   frontend tile and the pipeline's 64 x 64 grid) and their library
   calls also get their device time (the launch overhead left out), FIR
   and conv2d on the runtime's launch and the generic instantiation;
4. serve  — full-width qwen1.5-0.5b (bf16, 24 layers, vocab 151936,
   random weights from a ``torch.Generator`` seeded with 0) on the slot
   engine: 4 slots, max_seq 128, 8 requests of 4-16 prompt tokens and 8
   new tokens each.  Checks every request's budget, that every planned
   site planned and never fell back, that both GEMM kernels launched
   during the drain, that the GEMMs ran on the kernel the runtime must
   pick for each shape (``check_routes``: the skinny kernel, but for the
   scores of odd-length prompts), that every GEMM shape the drain gave a
   site matches the plain version (``drain_parity``), and that each
   prompt's prefill logits match a second, explicit prefill through the
   plain versions.  One 4-lane decode step is then timed on the host
   clock and traced with ``torch.profiler`` for the card's busy time and
   the share of each GEMM kernel;
5. paged  — the same model, weights and requests on the block-paged
   engine (4 lanes, max_seq 128, blocks of ``PAGED_BLOCK`` rows), its
   decode step captured once in ``load()`` as a CUDA graph; each load is
   a window of its own (one capture; its GEMM launches by kernel held to
   the shapes its report gives, ``check_routes``).  First with
   exact-length prefills (``SchedulerConfig(bucketed=False)``), whose
   tokens must equal the slot engine's; then with bucketed prefills, the
   main path of the paged engine, traced by ``torch.profiler`` (CUDA
   activity): the serve phase's checks on the drain (``check_routes`` on
   its eager launches, the bucketed prefills' logits at each prompt's
   last token), and its launches counted as set out below.  Then the
   captured step's host time (median of 5: stage the tables, replay,
   read the tokens) and the card's busy time and kernel launches in one
   replay, beside the same step run eagerly and the slot engine's eager
   step;
6. prefill — the same model on the slot engine with max_seq 640 serving
   4 prompts of 64, 127, 256 and 512 tokens, 8 new tokens each: the
   serve phase's checks (budgets, every site planned, ``check_routes``:
   every prefill GEMM above 16 rows on the tensor-core kernel,
   ``drain_parity``, prefill logits against the plain versions), then
   one prefill of 512 tokens timed on the host clock and traced;
7. stream — full-width whisper-base (bf16, 6+6 layers, d 512, vocab
   51865, random weights seeded with 0) on the slot engine: 4 slots,
   max_seq 128, 8 streamed int16 audio requests of 1-8 chunks and 8 new
   tokens each, every chunk through the planned frontend (FIR and conv2d
   kernels, the fft2d chain's ``xla`` stamp) and the incremental encoder.
   Checks every budget, that every site planned with no fallback
   (``frontend.*`` and ``mlp.pair`` included), that the GEMM, FIR and
   conv2d kernels launched during the drain, that every GEMM shape the
   drain gave a site matches the plain version (the d 512 projections,
   the lm_head over 51865 columns, the encoder chunk attention, the
   cross-attention over the 1500-row encoder cache), and that one
   request's features and stream-prefill logits match a run through the
   plain versions;
8. paged stream — the same weights and 8 audio requests on the paged
   engine, its decode step captured in ``load()``: first with
   exact-length prefills, whose tokens must equal the slot engine's, then
   with bucketed ones, traced: the stream phase's checks on the drain
   (every chunk fed, one FIR and one conv2d launch per chunk on the 5 x 4
   window, the frontend's stamps, the features and stream-prefill logits,
   the first token the argmax of the bucketed prefill over the first
   chunk), and ``decode_compiles == 1``;
9. long_prompt — blockwise attention forced at S = 2048 on the card
   against ``sdpa`` on the hand kernels (fp32, causal and not, the CPU
   test's tolerance); then full-width qwen1.5-0.5b at max_seq 8448
   serving prompts of 2049, 4096 and 8192 tokens (attention above 2048
   rows blockwise, over ``torch.matmul``), 8 new tokens each, on the slot
   engine and on the paged engine (exact-length prefills, its decode step
   captured in ``load()`` at 528 blocks a lane): every budget, every site
   planned, ``check_routes``, the two engines' greedy tokens equal,
   ``drain_parity``, each prompt's prefill logits against the plain
   versions; the 8192-token prefill's host time and its device time by
   kernel (the tensor-core GEMM, the blockwise products under
   ``torch.matmul``, other kernels), and the captured paged step's with
   every lane installed over blocks of its own at its last row (the
   gather reads each lane's whole K and V);
10. offline_audio — full-width whisper-base serving 4 text requests, each
   with its own [1500, 512] frames (numpy draws from a seed rounded to
   bf16, as ``launch.serve`` draws them), prefilled offline (encoder over
   the frames, cross K/V, prompt) on the slot and the paged engine: the
   checks of phase 9 (the MLP pair on its ``xla`` plan) and the encoder's
   host and device time over one utterance.  Then the GEMMs these two
   phases add (``LONG_SHAPES``: qwen's prefill GEMMs at 8192 rows, the
   decode scores and values over 8448 keys, the encoder's scores and
   values over 1500 frames) against their plain versions and timed beside
   ``torch.matmul``/``torch.bmm`` and their bounds;
10b. hier — two-level hierarchical plans (``core/hierarchy.py``) under
   ``SERVING_HIERARCHICAL_TARGET`` (outer 1 x 2 over the facade's inner
   target; ``--hier`` runs this phase alone): every GEMM kernel reading a
   group's slice of B (and a row split's slice of A) at its pitch,
   bitwise against the same launch on contiguous copies (``PITCHED``);
   ``lower_hierarchical(plan, "pallas")`` at ``HIER_CASES``, one
   hand-kernel launch a group, against the flat plan and the plain
   version with the three device times side by side; full-width
   qwen1.5-0.5b (8 prompts of 4-512 tokens) and whisper-base's offline
   text requests on both engines under the target: every site two-level
   or falling back as the copied planner says (the MLP pair), the groups'
   launches by kernel what their sub-shapes call for, slot == paged
   tokens, ``decode_compiles`` 1, first logits within 0.25 of the flat
   plan's, and the captured step and the longest prefill beside a flat
   engine's; its rows also give the library call at a group's sub-shape
   and the composition's bound;
10c. systolic — the chip-level schedules (``kernels/systolic.py``) on
   logical meshes of this card (``parallel.mesh``, 8 logical devices, all
   this card; ``--systolic`` runs this phase alone): every registered
   spec's ``systolic`` and ``allgather`` lowering at its bench cases on
   1 x 1 and 2 x 2 meshes (conv2d, fir and jacobi2d_9pt on 2 x 4 too),
   ``fused_systolic`` on 2 x 2 for the mm+mm and fft2d chains and on 2 x
   4 for conv2d -> jacobi2d (``SYSTOLIC_FUSED``), and
   ``lower_hierarchical`` on both backends at outer 2 x inner 2 x 2
   (``SYSTOLIC_HIER``), each held to the flat hand-kernel path on the
   same operands (integers bitwise, floats within
   ``recurrences.float_bound``, fft2d within its atol), its launches by
   wrapper equal to what its members' compute makes
   (``schedule_launches``: every member on its hand kernel), the bytes
   ``ppermute`` / ``all_gather`` moved equal to ``parallel/collectives.py``'s
   model (``schedule_bytes``), and its CUDA-event time beside the flat
   path's: the members' work one after another on one card with no
   interconnect, not a speed figure;
11. olmoe — full-width olmoe-1b-7b, the MoE family (bf16, 16 layers,
   64 experts of ff 1024, top-8, 13.8 GB of random weights seeded with 0
   and drawn on the card), after the earlier phases' weights are freed.
   First the block's parts alone on layer 0's weights at 4 and 512
   tokens (``moe_parts``): the fp32 router on the skinny kernel and on
   ``gemm_tc_kernel`` (3xTF32) against the plain version, ``route``,
   ``dispatch_indices`` and ``dispatch`` on the card against the host's
   on the same logits, each expert bmm (``skinny_kernel`` at C = 1,
   ``gemm_tc_kernel`` at C = 80) against the plain version, the combine
   bit for bit the host's, the block deterministic.  Then 4 prompts of
   4-16 tokens and 4 of 64, 127, 256 and 512, 8 new tokens each, on the
   slot engine and on the paged engine (exact-length prefills, its
   decode step captured in ``load()``; ``two_engines`` without the
   equal-tokens check: capacity couples the 4 lanes, which the engines
   fill in other orders): every site planned with no fallback at
   ``moe.router``/``moe.gate``/``moe.up``/``moe.down``,
   ``check_routes``, ``drain_parity`` (the router in float32), each
   prompt's prefill logits against the plain versions (a request past
   ``LOGIT_ATOL`` passes only where the routing flips that caused it
   begin with near-ties within ``ROUTER_ATOL`` and the plain versions
   with the kernels' routing forced come within ``LOGIT_ATOL``: every
   flip printed, ``routing_explained``), the paged engine's first tokens
   the slot engine's; the eager decode step, the captured paged step and
   a 512-token prefill profiled; last, 1-lane slot == paged tokens;
12. ssm — full-width mamba2-780m (48 Mamba2 layers, d 1536, state 128)
   and zamba2-1.2b (38 Mamba2 layers, d 2048, state 64, one shared
   attention + MLP block of 32 heads and ff 8192 applied 6 times), bf16,
   random weights seeded with 0 and drawn on the card, one after the
   other.  For each, one Mamba2 block over 300 tokens (``ssm_parts``):
   its output and final state against the same block in fp32 on the
   host, and the chunked scan's final state against 300 recurrent steps
   on the card, each within its stated bound.  Then 4 prompts of 4-16
   tokens and 4 of 64, 255, 300 and 512 (one SSD chunk, a padded second,
   two whole), 8 new tokens each, on the slot engine and on the paged
   engine (exact-length prefills; the conv and SSM states ``lane`` leaves
   written in place by the decode step captured in ``load()``): the two
   engines' tokens equal at 4 lanes, every site the reference plans
   planned with no fallback and no other (``SSM_SITES``: mamba2 only
   ``lm_head``), ``check_routes``, ``decode_compiles`` 1,
   ``drain_parity``, each prompt's prefill logits against the plain
   versions; the eager decode step, the captured paged step and a
   512-token prefill profiled;
12b. dense_configs — llava-next-mistral-7b (vlm: 576 seeded bf16 patch
   embeddings a request through ``vlm.patch_proj``, prefills of 580-1088
   rows), stablelm-12b (head dim 160), codeqwen1.5-7b (an fp8 e4m3 KV
   cache) and qwen3-32b (65.5 GB of weights), each at its published
   width and depth, bf16, random weights seeded with 0 drawn on the card
   and freed before the next (``dense_phase``): prompts of 4, 9, 13, 16,
   64, 127, 256 and 512 tokens, 8 new tokens each, on the slot and the
   paged engine (the tokens equal), every site planned with no fallback,
   ``decode_compiles`` 1, ``check_routes`` (no tiled launch: qwen3-32b's
   down projection of the 16-token prompt, K = 25600, on the skinny
   kernel, A streamed through its ring), ``drain_parity``, the prefill
   logits within
   ``LOGIT_ATOL``, the captured step and a 512-token prefill profiled, the
   peak of allocated memory, and ``DENSE_SHAPES`` timed;
12c. deepseek — deepseek-v2-236b (MLA: a 576-element latent cache a token
   a layer, decoded in the absorbed form; 160 experts top-6 and 2 shared,
   a dense first layer) at its published width cut to
   ``DEEPSEEK_LAYERS`` = 8 of its 60 layers (29.19 B parameters, 54.37 GiB
   in bf16; the whole model's 471.6 GB fit no card), seeded random
   weights drawn on the card (``deepseek_phase``): phase 12b's prompts
   and checks on both engines at 4 lanes (only the first tokens equal:
   capacity couples the lanes) and at 1 lane (the tokens equal), every
   ``DEEPSEEK_SITES`` site planned, no tiled launch, the logits within
   ``LOGIT_ATOL`` or a miss explained by near-tie routing, the captured
   step and a 512-token prefill profiled, the peak, ``DEEPSEEK_SHAPES``
   timed, the phase's seconds;
12d. mesh — the MoE mesh paths, training and the collectives on 8
   logical devices of the card (``mesh_phase``): ``mesh_moe_ep``
   (deepseek-v2-236b at its published width cut to ``MESH_EP_LAYERS`` =
   4 of 60 layers, its config's ``moe_ep``: an EP prefill of 4 x 512
   tokens on a (1, 4) mesh, held at the config's capacity factor to the
   same mesh path on the plain versions and, nothing dropping, to one
   device's prefill), ``mesh_moe_tp`` (olmoe-1b-7b uncut on (2, 2),
   nothing dropping: a TP prefill of 4 x 512 and 16 decode steps fed one
   device's greedy tokens, against one device's; a miss past
   ``LOGIT_ATOL`` only through near-tie routing), ``mesh_train``
   (qwen1.5-0.5b's elastic run, 3 steps on 4 x 2 and 2 resumed on 2 x 2,
   bit for bit one device's; olmoe's float32 expert gradients under (2,
   2) with the mesh's routing forced on one device, and 2 bf16 steps at
   10 layers), ``mesh_collectives`` (the ring at mm(8192, 8192, 1024)
   bf16 / float32 and int8 at k = 10240, ``quantized_psum``, GPipe of
   qwen's 24 layers over 4 stages), each path's launches, bytes moved and
   host time beside one device's; then ``MESH_SHAPES`` and the int8 ring
   partial timed;
12e. dryrun — the dry run (``launch/dryrun.py``, ``dryrun_phase``):
   qwen1.5-0.5b's 4-lane decode step over a 512-row cache and a
   512-token prefill counted on fake tensors on a 1 x 1 mesh, then run
   for real: the fake GEMM launches by kernel and variant equal the
   wrappers' real ones, the parameters' argument bytes equal the
   allocated delta of building them within the allocator's rounding
   (``alloc_slack``), and the
   predicted activation peak is printed against the real step's
   ``max_memory_allocated`` above its arguments (``--dryrun`` runs this
   phase, then every cell of the grid on both production meshes);
13. train — full-width qwen1.5-0.5b trained (bf16, 24 layers, vocab
   151936, remat "full"; train_4k's 4096 x 256 tokens cut to 512 x 8),
   ``train_phase``: (a) one float32 step, the same seeded weights and
   batch, on the kernels (float32 GEMMs as 3xTF32) and under
   ``configure(enabled=False)``, the loss and every gradient leaf within
   ``GRAD_RTOL`` relative (L2; a leaf whose exact gradient is 0, a key
   bias without rotary positions, within ``ZERO_GRAD_SHARE`` of the whole
   gradient's norm on both paths); (b) ``Trainer`` over ``TRAIN_STEPS``
   bf16 steps from seeded weights, every count set to 0 just before and
   read just after: every forward site and each of its ``/bwd_*`` sites
   planned with no fallback, no tiled GEMM launch; (c) every loss
   finite, the last 5 steps' mean below the first 5's, a fresh
   ``Trainer`` resuming at the last step with the saved parameters bit
   for bit; (d) one step's host time (median of 5), the forward, the
   backward (the remat recompute included) and AdamW traced apart by
   ``torch.profiler`` (device busy and idle share, the backward's GEMMs
   by kernel), the A operands copied to row-major, tokens a second; then
   the backward GEMMs of ``TRAIN_SHAPES`` (the weight gradients at K =
   4096 tokens, the tied lm_head's dx at K = 151936 and dW, the scores'
   and values' da / db) against their plain versions (past
   ``runtime.TC_PROMOTE_K``, one bf16 rounding plus ``sum_bound``) and
   timed beside ``torch.matmul`` and their bounds;
14. whisper_train — full-width whisper-base trained the same way (bf16,
   6+6 layers, vocab 51865; 4 utterances of 1500 frames and 64 text
   tokens, ``grad_accum`` 4 -> 1), the MLP pair's five backward sites
   among the checked ones, its encoder scores' da / db timed (dB with
   its B, the cotangent, in the padded rows the backward casts it into,
   beside B in its own rows on the cp.async producer and beside the
   tiled kernel it left);
14b. mamba2_train, zamba2_train, olmoe_train — mamba2-780m (its published
   ``grad_accum`` 2: two microbatches of 4 x 512 accumulated), zamba2-1.2b
   and olmoe-1b-7b (``grad_accum`` 2 -> 1, its load-balance term in the
   loss, trained at 10 of its 16 layers, ``depth_cut``; check (a)
   at ``MOE_PARITY_LAYERS`` layers, where a gradient miss passes only as
   routing near-ties, ``routing_explains_grads``) trained the same way,
   8 x 512 tokens; the resume of check (c) runs after (d), with the first
   run's parameters on the host; each phase prints its allocated peak;
15. recurrences — the WideSA mapper -> kernel pipeline,
   ``repro_torch.launch.recurrences.run`` (the entry point's function):
   the Table II compiler report, quickstart's 1024^3 MM, and every
   registered recurrence planned on one chip and run through
   ``lower_plan(plan, "pallas")`` against its plain version, the stencils
   and mttkrp at their paper-scale bench sizes in every parity dtype, mm
   and bmm at the paper's MM/BMM table (float32 8192^3, int8 10240^3,
   int16 9600^3, int32 8192^3; 64 x 4096^3 in float32, int8 and int16),
   conv2d at the paper's conv2d table, fir at the paper's FIR table (16
   launches on the 15-tap instantiation), fft2d_stage at its "cfloat" and
   "cint16" 8192^2 grids on the FFT kernel (the registry's atol 1.0).  Checks that every star and
   conv2d case ran the launch the runtime chose for it (star_kernel for one
   sweep, sweeps_kernel in ceil(T / T_b) launches of T_b >= 2 for
   jacobi2d_ms, conv2d on its compiled window), each launch counted under
   its variant, that the star-stencil (B6) and MTTKRP (B7) kernels launched,
   every mttkrp case on the kernel its dtype and shape call for (every
   bench case on the tensor cores, int16 and int32 as int8 limbs) with
   each launch counted under it, fft2d_stage's two 8192^2 bench cases on
   the FFT kernel (two passes a transform, counted under ``fft``), and
   every mm / bmm case (all above 16 rows) on the tensor-core
   kernels, float32 and integers, with every launch of the two GEMM
   wrappers counted under ``wgmma``.  Then holds B6 (5-point, 9-point, and the multi-sweep
   form on its int32 state) and B7 against their plain versions at the
   bench sizes and at ragged ones, in float32, int8, int16 and int32, on
   the kernel the runtime routes each to (the fused jacobi2d_ms in
   ceil(T / T_b) launches, and in float32 bitwise equal to one launch a
   sweep), checks that the float32 bound
   rejects a TF32 control (the plain MTTKRP with TF32 GEMMs on), and
   times them beside their plain versions, one PyTorch call
   (``F.conv2d`` with the star as a zero-padded filter, ``torch.einsum``;
   yardsticks only) and their bounds, with ``torch.profiler`` device
   time; the tensor-core MTTKRP rows also time the CUDA-core kernel on
   the same operands and give the bound at the tensor-core rate beside
   the fp32 CUDA-core one, and the jacobi2d_ms rows the host time of a
   synchronized call, its launches, the 8-pass floor and the device time
   with each T_b of 1, 2, 4 and 8.  Last, the integer GEMMs above 16 rows at the
   pipeline's smoke shapes and the paper's table (``int_gemm_timings``:
   ``gemm_tc_int_kernel`` and its limb pre-pass bitwise against the plain
   version and beside the tiled kernel they replace, ``torch._int_mm``
   for int8 mm, the bound at the int8 rate x 1, 4 or 10 limb products)
   and the paper's float32 MM and BMM on ``gemm_tc_kernel``;
   The GEMMs the MoE path adds (``MOE_SHAPES``: the float32 router at 4
   and 512 rows, the expert stack at C = 1 and 80) and those the SSM and
   hybrid paths add (``SSM_SHAPES``: the two lm_heads at decode, zamba2's
   shared block at decode and its gate/up at 512 rows) are timed beside
   ``torch.matmul``/``torch.bmm`` and their bounds after phase 14;
16. summary — a JSON line of the kernels, the ``nvidia-smi`` name and
   power limit, and the result line.

Every wrapper's launch count is set to 0 just before each serving drain
and before the recurrence pipeline, and read just after; the kernels
line gives each path's counts apart (``"launches": {"qwen": n,
"qwen_paged": q, "qwen_prefill": p, "whisper_stream": m,
"whisper_paged": w, "qwen_long": l, "whisper_offline": o,
"hier_recurrences": h, "qwen_hier": ..., "qwen_hier_paged": ...,
"whisper_hier": ..., "whisper_hier_paged": ..., "systolic_1x1": ...,
"systolic_2x2": ..., "systolic_2x4": ..., "systolic_fused": ...,
"systolic_hier": ..., "olmoe": s,
"olmoe_paged": g, "mamba2": a, "mamba2_paged": b, "zamba2": z,
"zamba2_paged": y, "llava": v, "llava_paged": v', "stablelm": ...,
"codeqwen": ..., "qwen3": ..., "qwen3_paged": ..., "deepseek": ...,
"deepseek_paged": ..., "mesh_moe_ep": ..., "mesh_moe_tp": ...,
"mesh_train": ..., "mesh_collectives": ..., "dryrun": ..., "train": t,
"whisper_train": u, "mamba2_train": ..., "zamba2_train": ...,
"olmoe_train": ..., "recurrences": k}``; ``qwen_long`` and ``whisper_offline`` each sum the slot engine's
drain and the paged engine's; ``train`` and ``whisper_train`` count the
``Trainer``'s ``TRAIN_STEPS`` steps, set to 0 just before its
``run``).  A replay of a captured step passes no wrapper, so a paged path's drain runs under ``torch.profiler``
and its count is what the wrappers counted (the eager prefills and chunk
feeds) plus the GEMM launches that the trace shows in the drain's
replays; the trace's GEMM launches outside the replays must equal the
wrappers' counts, and those in the replays the drain's steps times the
captured step's launches, half its load window's), and for the
two GEMM wrappers the same launches by kernel (``"launches_by_kernel"``:
skinny / wgmma / tiled) beside their device times and host time a call
(and under ``"wgmma"`` the tensor-core kernel's at its 512-token prefill
shape beside the tiled kernel's and the library's; under ``"wgmma_int"``
the integer one's, ``gemm_tc_int_kernel`` with its limb pre-pass, at the
paper's int8 shape beside the tiled kernel's and ``torch._int_mm``'s;
both count as ``wgmma``), for mttkrp its
launches by kernel (tensor_core / cuda_core) beside the device times of
both kernels, for conv2d its launches by window (4x4 / 8x8 / 5x4 /
generic) beside the paper's conv2d table, for fir its launches by
instantiation (15 / 7 / generic; real and complex alike) beside the
paper's FIR table and ``fir_complex``, and for the stars theirs by
kernel (star5 / star9 on star_kernel, sweeps on sweeps_kernel) beside
the other timed stars and jacobi2d_ms's call.  The GEMM wrappers' entries
also hold, under ``"long"``, each ``LONG_SHAPES`` GEMM's device time,
plain and library times, bound and launches on ``qwen_long`` and
``whisper_offline``: the calls the drains' planned reports count (every
eager call), plus the paged drain's steps times the launches that its
first whole traced replay shows at the shape's kernel and grid
(``launch_signature``: the grid the launcher sets for the shape's
configuration); under ``"moe"`` each ``MOE_SHAPES`` GEMM's the same, with
its launches on ``olmoe`` and ``olmoe_paged``; under ``"ssm"`` each
``SSM_SHAPES`` GEMM's, with its launches on the four SSM and hybrid
paths (shapes whose launches share a kernel and grid in a replay, as
zamba2's q/k/v/out and mlp.down projections at decode, take their
captured step's counts, which must sum to what the replay shows);
under ``"dense"`` each ``DENSE_SHAPES`` GEMM's, with its launches on its
model's slot and paged paths; under ``"deepseek"`` each
``DEEPSEEK_SHAPES`` GEMM's, with its launches on the deepseek paths; under
``"mesh"`` each ``MESH_SHAPES`` GEMM's (and the int8 ring partial's), with
its launches on the mesh paths; under ``"train"`` each ``TRAIN_SHAPES``
GEMM's, with its launches in one train step (every site of that shape, the remat recompute's forward
launches included).  The
comparison and timing launches of phases 3 and
7, those of the paged phases outside their main drains, of
``drain_parity``, of the logit checks, of check (a) and the profiles do
not count.

``--train`` runs only the device phase, the GEMM source's build and
the train phases (13, 14, 14b); ``--dense`` the device phase, the GEMM
source's build and phases 12b and 12c; ``--mesh`` the device phase, the
GEMM source's build and phase 12d.  ``--tile-sweep`` runs only the device
and build
phases, then times the tiled GEMM in bf16 with each of the 24 tiles of ``build.SWEEP_TILES`` (a
second library holds those not compiled for the main path) and the
skinny GEMM with every split of K, at every main-path shape, and prints,
per shape, the tile ``runtime.hopper_tiles`` picks, the skinny
configuration ``runtime.gemm_tile`` picks and the fastest of each
(``--out`` writes all times as JSON).  ``--mttkrp-sweep`` builds only the
HPC source, then holds the tensor-core MTTKRP at the bench size in
float32, int8, int16 and int32 with every split of K (1 to 8) to the
plain version and prints each split's device time beside the CUDA-core kernel's and
``torch.einsum``'s.  ``--tc-sweep`` builds only the GEMM source, then
holds the tensor-core GEMM at the qwen prefill shapes of 512, 127 and 64
tokens (bf16) and at quickstart's float32 1024^3 to the plain version with
every compiled tile, split of K (1-4) and ring of 2 or 4 stages, and prints
each one's device time beside the runtime's pick and ``torch.matmul`` /
``torch.bmm``'s.  ``--fft-sweep`` builds the GEMM, signal-processing
and FFT sources, then holds the fused fft2d kernel at 12 x 515, 16 x 1024
and 64 x 64 with every split of K it takes to ``ref.fft2d`` and prints
each one's device time beside the composition's and ``torch.fft.fft2``'s,
and the FFT kernel at 8192^2 and 4096 x 256 with its configurations (rows
a row-pass block, columns a column-pass block, blocks a cluster: 1-16),
each held to its plain version, beside ``torch.fft.fft2``.
``--conv2d-sweep`` builds the signal-processing source, then holds conv2d
over 10240^2 outputs with filters from 3 x 3 to 32 x 32 (``CONV2D_SWEEP``)
to ``ref.conv2d`` and prints the device time of the runtime's launch and
of the generic window beside ``F.conv2d``'s; ``--fir-sweep`` holds
float32 FIR over 2^20 to 2^26 outputs at 7, 15, 64 and 255 taps, int8 and
int16 at the bench shape and the frontend's int16 (``FIR_SWEEP``) to
``ref.fir`` and prints the device time of the runtime's launch beside
``F.conv1d``'s and a ``copy_`` of the same bytes.  With ``--src`` either
imports the port from another checkout's ``src/`` instead, to time an
earlier kernel in the same call (run parent, change, change, parent).

Tolerances: integer results are bit-exact (wrapping int32, as XLA);
float32 results within the kernel registry's atol 1e-3 (sums of up to
2816 products, 3xTF32 on the tensor-core GEMM; 1.0 for the
fft2d, the registry's fft2d_stage atol: fp32 sums of 515
terms of magnitude ~100, and the FFT kernel's outputs of up to ~3e4 at
8192^2); bf16 results within ``2^-7 * |ref| + 1e-3``,
one bf16 rounding step of the output (8-bit significand) on top of fp32
sums taken in another order.  The logits of the whole bf16 models are
held to ``LOGIT_ATOL`` (see there); the int16 frontend features are
exact.  The stencils' and mttkrp's float32 results are held to
``recurrences.float_bound``: the registry's atol 1e-3 plus ``8 sqrt(n)
2^-24`` times the root of the sum of each output's squared terms (n
terms an output, zero-mean operands), since at the bench sizes mttkrp
sums 65536 products of magnitude ~1 and |M| reaches the hundreds.
"""

from __future__ import annotations

import ast
import contextlib
import itertools
import json
import math
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: peak rates of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s
#: and bf16 / fp32 (CUDA cores) / TF32 and int8 (tensor cores) operations
#: per second.  FIR and conv2d run on the CUDA cores in every dtype, and
#: the data sheet gives no integer rate for them, so their operations
#: count at the fp32 rate (a bound that is low for integers; the bytes
#: bound them at every shape timed here anyway)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12,
                  "tfloat32": 495e12}

#: prefill logits of the bf16 models (24 layers of qwen, 6+6 of whisper),
#: hand kernels vs the plain versions: every GEMM output rounds to bf16
#: (2^-8 relative) and the two paths sum in different orders, so roundings
#: flip between them and the flips propagate through the residual layers;
#: logits are O(1) here
LOGIT_ATOL = 0.25

ARCH = "qwen1.5-0.5b"
STREAM_ARCH = "whisper-base"
SLOTS, MAX_SEQ, REQUESTS, MAX_NEW = 4, 128, 8, 8

#: the serving GEMMs of the qwen path timed in phase 3 (prefill of a
#: 12-token prompt and a 4-lane decode step), as (site, kind, shape, B
#: column-major, launches in one decode step of the 24-layer model); the
#: shapes each drain really gives are checked after it (``drain_parity``)
MAIN_SHAPES = (
    ("attn.q/k/v/out, prefill", "mm", (12, 1024, 1024), False, 0),
    ("mlp.gate/up, prefill", "mm", (12, 2816, 1024), False, 0),
    ("mlp.down, prefill", "mm", (12, 1024, 2816), False, 0),
    ("lm_head, prefill", "mm", (1, 151936, 1024), True, 0),
    ("attn.q/k/v/out, decode", "mm", (4, 1024, 1024), False, 96),
    ("mlp.gate/up, decode", "mm", (4, 2816, 1024), False, 48),
    ("mlp.down, decode", "mm", (4, 1024, 2816), False, 24),
    ("lm_head, decode", "mm", (4, 151936, 1024), True, 1),
    ("attn.decode_scores", "bmm", (64, 1, 128, 64), True, 24),
    ("attn.decode_values", "bmm", (64, 1, 64, 128), False, 24),
    ("attn.scores, prefill", "bmm", (16, 12, 12, 64), True, 0),
    ("attn.values, prefill", "bmm", (16, 12, 64, 12), False, 0),
)
#: the GEMMs timed: MAIN_SHAPES, whisper-base's tied lm_head over its
#: 51865-word vocabulary (a 4-lane decode step), B column-major, and the
#: decode scores with K^T materialized row-major (the layout before the
#: scores read K column-major), for the comparison
TIMED_SHAPES = MAIN_SHAPES + (
    ("lm_head, whisper-base decode", "mm", (4, 51865, 512), True, 0),
    ("attn.decode_scores, K^T row-major", "bmm", (64, 1, 128, 64), False,
     0))
#: qwen1.5-0.5b's prefill GEMMs of a P-token prompt (A of P rows: the
#: tensor-core kernel), as (site, kind, shape, B column-major, launches in
#: one prefill of the 24-layer model)
def prefill_shapes(p):
    return (("attn.q/k/v/out", "mm", (p, 1024, 1024), False, 96),
            ("mlp.gate/up", "mm", (p, 2816, 1024), False, 48),
            ("mlp.down", "mm", (p, 1024, 2816), False, 24),
            ("attn.scores", "bmm", (16, p, p, 64), True, 24),
            ("attn.values", "bmm", (16, p, 64, p), False, 24))


#: prompt lengths of the tensor-core parity cases, the prefill timed, and
#: the prompts the prefill phase serves
TC_PROMPTS = (17, 64, 127, 512)
TC_TIMED_PROMPT = 512
PREFILL_PROMPTS = (64, 127, 256, 512)
PREFILL_MAX_SEQ = 640
#: quickstart's float32 MM, and ragged shapes (M and N no multiple of any
#: tile, K rows whole 16-byte units) for the tensor-core kernel
QUICKSTART = ("mm", (1024, 1024, 1024))
TC_RAGGED = (("mm", (100, 200, 136)), ("bmm", (3, 61, 72, 64)),
             ("mm", (100, 202, 1002)))
RAGGED_SHAPES = (("mm", (61, 126, 37)), ("mm", (1, 300, 77)),
                 ("bmm", (3, 61, 126, 37)), ("bmm", (5, 7, 33, 130)))
#: the skinny kernel at every row count up to 16: N, and a K that no split
#: divides (B above 1 MiB in every dtype, so the runtime splits K over 8
#: blocks of a cluster)
SKINNY_NK = (96, 11004)
#: bytes of distinct B operands a weight GEMM is timed over, so that each
#: launch reads its B from HBM as a decode step does (the L2 holds 50 MB)
COLD_BYTES = 80 * 2**20

#: the kernel row of each ported TPU kernel: its main-path shape for the
#: timing columns, what it replaces and where its source is
SOURCE = "src/repro_torch/kernels/csrc/widesa_mm.cu"
SP_SOURCE = "src/repro_torch/kernels/csrc/widesa_sp.cu"
HPC_SOURCE = "src/repro_torch/kernels/csrc/widesa_hpc.cu"
FFT_SOURCE = "src/repro_torch/kernels/csrc/widesa_fft.cu"
KERNELS = {
    "widesa_mm": dict(kind="mm", shape=(4, 151936, 1024), col_major=True,
                      replaces="src/repro/kernels/widesa_mm.py:31",
                      source=SOURCE),
    "bmm": dict(kind="bmm", shape=(64, 1, 128, 64), col_major=True,
                replaces="src/repro/kernels/bmm.py:24", source=SOURCE),
    "fir": dict(replaces="src/repro/kernels/fir.py:25", source=SP_SOURCE),
    "conv2d": dict(replaces="src/repro/kernels/conv2d.py:32",
                   source=SP_SOURCE),
    # the fused kernel up to 64 rows (fft2d_kernel); the taller grids whose
    # sides are powers of two run the FFT kernel, fft_pass_kernel (the
    # next entry, its launches those of this wrapper's ``fft`` form), the
    # rest the composition over the GEMMs above
    "fft2d": dict(replaces="src/repro/kernels/fft2d.py:34",
                  source=SP_SOURCE),
    "fft2d_fft": dict(replaces="src/repro/kernels/fft2d.py:34",
                      source=FFT_SOURCE),
    # star_kernel for jacobi2d and jacobi2d_9pt, sweeps_kernel for
    # jacobi2d_ms
    "jacobi2d": dict(replaces="src/repro/kernels/jacobi2d.py:31",
                     source=HPC_SOURCE),
    "mttkrp": dict(replaces="src/repro/kernels/mttkrp.py:29",
                   source=HPC_SOURCE),
}

#: the tensor-core kernel's row in the kernels line: the P = 512 prefill
#: shape of each GEMM wrapper
WGMMA_SHAPES = {"widesa_mm": ("mm", (512, 1024, 1024), False),
                "bmm": ("bmm", (16, 512, 512, 64), True)}

#: the frontend shapes of whisper-base (FrontendConfig(d_model=512): a
#: 12 x 515 tile of 6180 samples, 15 taps, a 5 x 4 filter, int16), ragged
#: shapes (conv2d: each compiled window, and filters of the generic
#: instantiation), and the registry's bandwidth-sized bench shapes
#: (float32; conv2d: every bench case, the paper's conv2d table)
SP_MAIN = {"fir": (6180, 15), "conv2d": (8, 512, 5, 4)}
SP_RAGGED = {"fir": ((1000, 7), (70001, 15), (511, 1), (513, 16),
                     (3001, 64), (1, 4096)),
             "conv2d": ((37, 70, 3, 5), (130, 333, 4, 4), (61, 600, 8, 8),
                        (3, 1, 5, 4), (70, 45, 1, 1), (40, 33, 32, 32),
                        (50, 100, 12, 7))}
SP_BENCH = {"fir": (1048576, 15), "conv2d": (10240, 10240, 4, 4)}
#: what the cfloat FIR bench case runs, as the reference's execute_plan
PLANES_NOTE = (": the cfloat plan on float32 planes, one real launch, not "
               "complex arithmetic")
#: the element offsets into its storage of the FIR input views held to the
#: plain version (x starting 4-12 bytes past a 16-byte boundary)
FIR_OFFSETS = (1, 2, 3)
FFT_MAIN = (12, 515)
#: the fused fft2d kernel's parity shapes: the frontend's, a wider one, a
#: single row, ragged ones (C no multiple of 4 or of the 32-column tile),
#: and the recurrence pipeline's fft2d_stage smoke grid (64 rows: the
#: kernel's largest), the two timed
FFT_PIPELINE = (64, 64)
FFT_SHAPES = (FFT_MAIN, (16, 1024), (1, 7), (12, 67), (7, 130), FFT_PIPELINE)
#: the FFT kernel's parity shapes: a square, a tall grid over a cluster of
#: 8, long rows, one column pair, the pipeline's bench grid (timed)
FFT_KERNEL_SHAPES = ((128, 128), (4096, 256), (512, 8192), (8192, 2),
                     (8192, 8192))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def wrappers() -> dict:
    """Each kernel's wrapper module, which holds its launch count."""
    from repro_torch.kernels import (bmm, conv2d, fft2d, fir, jacobi2d,
                                     mttkrp, widesa_mm)

    return {"widesa_mm": widesa_mm, "bmm": bmm, "fir": fir,
            "conv2d": conv2d, "fft2d": fft2d, "jacobi2d": jacobi2d,
            "mttkrp": mttkrp}


def reset_counts() -> None:
    for mod in wrappers().values():
        mod.launches = 0
        for variant in getattr(mod, "variants", {}):
            mod.variants[variant] = 0
        if hasattr(mod, "tiled_why"):
            mod.tiled_why.clear()


def read_counts() -> dict:
    return {name: mod.launches for name, mod in wrappers().items()}


def read_variants() -> dict:
    """The wrappers' launches by kernel: the GEMMs' (skinny / wgmma /
    tiled), mttkrp's (tensor_core / cuda_core), fft2d's (fused /
    composition)."""
    return {name: dict(mod.variants) for name, mod in wrappers().items()
            if hasattr(mod, "variants")}


def col_major_site(site: str, shape, tied: bool = True) -> bool:
    """Whether a serving site reads B column-major: the tied lm_head (the
    embedding table; ``tied`` False for a model with a head of its own),
    the attention scores (K^T as the transpose of K's rows) and a single
    column."""
    return (site == "lm_head" and tied) or "scores" in site \
        or shape[-2] == 1


def site_dtype(site: str) -> str:
    """A serving site's operand dtype: float32 for the MoE router (the
    reference's fp32 router GEMM), bf16 for every other GEMM."""
    return "float32" if site == "moe.router" else "bfloat16"


def padded_site(site: str) -> bool:
    """Whether a serving site's A comes in rows padded to whole 16-byte
    units: the prompt's attention values (the softmax weights)."""
    return site == "attn.values"


def padded(torch, a):
    """``a`` in rows padded to whole 16-byte units, as the attention layer
    hands the values bmm its softmax weights (a view of the first K
    columns)."""
    k, unit = a.shape[-1], 16 // a.element_size()
    rows = torch.empty((*a.shape[:-1], -(-k // unit) * unit), dtype=a.dtype,
                       device=a.device)[..., :k]
    rows.copy_(a)
    return rows


def tc_kernel(a_copy: int, b_copy: int) -> str:
    """The kernel the runtime must pick for more than 16 rows of a float A
    from the widest copy (16, 8, 4 or 0 bytes) that A's and B's rows
    allow, on fresh 16-byte aligned operands whose pitch is their rows'
    length (or padded rows, 16): the tensor-core kernel fed by TMA where
    both allow 16 bytes, by cp.async copies (``wgmma_cp``) where the
    narrower allows 8 or 4, else the tiled kernel."""
    if min(a_copy, b_copy) == 16:
        return "wgmma"
    return "wgmma_cp" if min(a_copy, b_copy) >= 4 else "tiled"


def serving_kernel(site: str, shape, tied: bool = True) -> str:
    """The kernel the runtime must pick for a serving GEMM (bf16, or
    float32 at the MoE router; fresh 16-byte aligned operands, A
    contiguous or, for the values, in padded rows): the skinny kernel for
    at most 16 rows of A, at any K (A streams through its ring beside B:
    qwen3-32b's down projection of a 16-token prompt, K = 25600,
    included), where B's rows allow 4-byte copies; for more rows
    ``tc_kernel``; else the tiled kernel.  The rule is stated here, not
    asked of ``runtime.gemm_tile``, so that the check holds the runtime to
    it."""
    from repro_torch.kernels import runtime

    m, n, k = shape[-3:]
    size = 4 if site_dtype(site) == "float32" else 2
    inner = k if col_major_site(site, shape, tied) else n
    if m <= runtime.SKINNY_ROWS:
        return "skinny" if runtime.copy_bytes(0, size * inner) >= 4 \
            else "tiled"
    return tc_kernel(16 if padded_site(site)
                     else runtime.copy_bytes(0, size * k),
                     runtime.copy_bytes(0, size * inner))


def check_routes(path: str, report: dict, variants: dict,
                 tied: bool = True) -> str:
    """Hold a serving drain's GEMM launches by kernel to what the runtime
    must pick for the shapes the drain gave each site (``serving_kernel``;
    the scores read K column-major and the values their weights in padded
    rows, so both take 16-byte units at any prompt length).  Fail on any
    other launch count; return the explanation of any tiled launch."""
    want = {"widesa_mm": {}, "bmm": {}}
    why = []
    for site, st in report.items():
        if site.startswith(NON_GEMM_SITES):
            continue
        for key, count in st["shapes"].items():
            shape = ast.literal_eval(key)
            kind = "widesa_mm" if len(shape) == 3 else "bmm"
            kernel = serving_kernel(site, shape, tied)
            want[kind][kernel] = want[kind].get(kernel, 0) + count
            if kernel == "tiled":
                why.append(f"{site} {shape} x{count}")
    got = {name: {v: n for v, n in variants[name].items() if n}
           for name in want}
    if got != want:
        fail(f"{path}: GEMM launches by kernel {got}, the shapes call for "
             f"{want} (tiled: {why})")
    return (f"tiled launches {sum(g.get('tiled', 0) for g in got.values())}"
            f", each for rows allowing no 4-byte copy: {why}" if why
            else "no tiled launch")


def route_report(report: dict, target) -> dict:
    """``report`` as the GEMM kernels see it: unchanged without a
    ``target``; under a hierarchical one each planned call of a site is
    ``target.groups`` launches at its plan's sub-shape (the groups of the
    split the copied planner picks), for ``check_routes``."""
    if target is None:
        return report
    from repro_torch.kernels import planned

    out = {}
    for site, st in report.items():
        if site.startswith(NON_GEMM_SITES):
            continue
        shapes = {}
        for key, count in st["shapes"].items():
            shape = ast.literal_eval(key)
            kind = "mm" if len(shape) == 3 else "bmm"
            plan = planned.plan_for(kind, shape, site_dtype(site),
                                    target=target)
            if plan is None:
                continue  # a fallback: checked_drain holds its reason
            sub = str(tuple(plan.sub_recurrence.extents))
            shapes[sub] = shapes.get(sub, 0) + count * target.groups
        out[site] = {"shapes": shapes}
    return out


def hier_fallback(site: str, st: dict, target) -> bool:
    """Whether a site's fallbacks under a hierarchical ``target`` are the
    copied planner's: reason ``infeasible``, and no plan for any shape the
    site gave (the MLP pair: a chain, which never composes
    hierarchically; its per-stage calls then plan)."""
    from repro_torch.kernels import planned

    if target is None or st["reasons"] != {"infeasible": st["fallback"]}:
        return False
    for key in st["shapes"]:
        shape = ast.literal_eval(key)
        kind = ("mm+mm" if isinstance(shape[0], tuple)
                else "mm" if len(shape) == 3 else "bmm")
        if planned.plan_for(kind, shape, site_dtype(site),
                            target=target) is not None:
            return False
    return True


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def draw(torch, gen, shape, dtype, device="cuda"):
    """Operands spanning each dtype's range (integers exercise wraparound)."""
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, shape, generator=gen,
                         device=device, dtype=torch.int64).to(dtype)


def operands(torch, gen, kind, shape, dtype, col_major):
    """A row-major, and B row-major or (``col_major``) the transpose of a
    row-major [.., N, K] tensor."""
    (m, n, k), lead = shape[-3:], shape[:-3]
    a = draw(torch, gen, (*lead, m, k), dtype)
    b = (draw(torch, gen, (*lead, n, k), dtype).transpose(-1, -2)
         if col_major else draw(torch, gen, (*lead, k, n), dtype))
    return a, b


def gemm_fn(kind):
    from repro_torch.kernels import bmm, widesa_mm

    return widesa_mm.matmul if kind == "mm" else bmm.bmm


def gemm_plan(kind, shape, dtype):
    from repro_torch.kernels import planned

    plan = planned.plan_for(kind, shape, planned.dtype_name(dtype))
    if plan is None:
        fail(f"no feasible plan for {kind}{shape} {dtype}")
    return plan


def kernel_call(kind, shape, dtype, a, b, out_dtype=None):
    """The hand kernel on the configuration the serving path picks for
    these operands (the registry's ``tiles``: ``runtime.gemm_tiles``):
    (call, HopperTiles)."""
    from repro_torch.kernels import registry

    tiles = registry.get(kind).tiles(gemm_plan(kind, shape, dtype), a, b)
    fn = gemm_fn(kind)
    return (lambda x, y: fn(x, y, tiles=tiles.tile, out_dtype=out_dtype)), \
        tiles


def tiled_call(kind, shape, dtype, col_major, out_dtype=None):
    """The tiled kernel at the tile the plan maps onto
    (``runtime.hopper_tiles``), as the serving GEMMs ran before the
    skinny kernel: (call, tile)."""
    from repro_torch.kernels import runtime

    tile = runtime.hopper_tiles(gemm_plan(kind, shape, dtype),
                                b_col_major=col_major).tile
    fn = gemm_fn(kind)
    return (lambda x, y: fn(x, y, tiles=tile, out_dtype=out_dtype)), tile


def describe(tile, kind=None, shape=None) -> str:
    """A GEMM launch configuration in words (with its grid for a shape)."""
    from repro_torch.kernels import runtime

    if isinstance(tile, runtime.TcTile):
        name = "wgmma_cp" if tile.producer == "cp" else "wgmma"
        text = (f"{name} {tile.bm}x{tile.bn} split {tile.split} stages "
                f"{tile.stages}")
        if shape is not None:
            (m, n), z = shape[-3:-1], (shape[0] if kind == "bmm" else 1)
            text += f" ({tile.blocks(m, n, z)} blocks)"
        return text
    if not isinstance(tile, runtime.SkinnyTile):
        return f"tiled {tuple(tile)}"
    text = f"skinny split {tile.split} x {tile.kblk}"
    if shape is not None:
        n, z = (shape[1], 1) if kind == "mm" else (shape[2], shape[0])
        text += f" ({tile.blocks(n, z)} blocks)"
    return text


def max_error(torch, out, want, dtype) -> tuple[float, bool]:
    """(max |out - want|, within tolerance) for one output dtype."""
    if out.shape != want.shape or out.dtype != want.dtype:
        return float("inf"), False
    diff = (out.double() - want.double()).abs()
    err = diff.max().item() if diff.numel() else 0.0
    if not dtype.is_floating_point:
        return err, err == 0
    if dtype == torch.float32:
        return err, err <= 1e-3
    bound = 2.0 ** -7 * want.double().abs() + 1e-3
    return err, bool((diff <= bound).all())


GEMM_DTYPES = ("float32", "bfloat16", "int8", "int16", "int32")


#: the skinny kernel's long sums: qwen3-32b's down projection (K = 25600,
#: B row-major) at a decode batch and at prompts of 9 and 15 rows (K split
#: 3, 5 and 8 ways); its fp32 sums may stray from the float64 sum at most
#: this many times as far as the plain version's fp32 sum does (before each
#: stage's tensor-core products were added in fp32: 12-20x, PR 26)
SKINNY_LONG_K = ((4, 5120, 25600), (9, 5120, 25600), (15, 5120, 25600))
SKINNY_SUM_RATIO = 4.0


def skinny_long_sums(torch) -> None:
    """``SKINNY_LONG_K`` on the skinny kernel in bf16, flushed to fp32 and
    to bf16: the fp32 sums' largest distance from the float64 sum within
    ``SKINNY_SUM_RATIO`` x the plain version's fp32 sum's, and the bf16
    results within one rounding plus 1e-3 of the plain version's."""
    from repro_torch.kernels import ref, runtime

    gen = torch.Generator(device="cuda").manual_seed(7)
    said = []
    for shape in SKINNY_LONG_K:
        a, b = operands(torch, gen, "mm", shape, torch.bfloat16, False)
        fn32, tiles = kernel_call("mm", shape, torch.bfloat16, a, b,
                                  torch.float32)
        if not isinstance(tiles.tile, runtime.SkinnyTile):
            fail(f"mm{shape}: {describe(tiles.tile)} is not the skinny "
                 "kernel")
        fn16, _ = kernel_call("mm", shape, torch.bfloat16, a, b)
        exact = a.double() @ b.double()
        kerr = float((fn32(a, b).double() - exact).abs().max())
        perr = float((ref.mm(a, b, torch.float32).double()
                      - exact).abs().max())
        err, ok = max_error(torch, fn16(a, b), ref.mm(a, b), torch.bfloat16)
        said.append(f"mm{shape} {describe(tiles.tile)}: fp32 {kerr:.4g} "
                    f"against the plain version's {perr:.4g} "
                    f"({kerr / perr:.2f}x), bf16 max |err| {err:.4g}")
        if kerr > SKINNY_SUM_RATIO * perr or not ok:
            fail(f"skinny long sums: {said[-1]} (bounds {SKINNY_SUM_RATIO}x"
                 f", bf16 2^-7|ref| + 1e-3)")
        del a, b, exact
    print(f"kernels: the skinny kernel's long sums (each stage's tensor-core "
          f"products added in fp32) against the float64 sum, bf16 operands "
          f"of N(0, 1), largest |err| (bound {SKINNY_SUM_RATIO}x the plain "
          f"fp32 sum's; bf16 <= 2^-7|ref| + 1e-3): {'; '.join(said)}",
          flush=True)


def parity(torch) -> None:
    """The GEMM kernels against their plain versions, all five dtypes: the
    serving and ragged shapes on the configuration the runtime picks; the
    skinny kernel at every M up to 16, both B layouts, K split unevenly;
    a misaligned B, which must take the tiled kernel; every compiled tile
    of the tiled kernel; the bf16 -> fp32 bmm; two runs of split-K float
    products bitwise equal."""
    from collections import Counter

    from repro_torch.kernels import bmm, build, ref, runtime, widesa_mm

    gen = torch.Generator(device="cuda").manual_seed(1)
    dtypes = [getattr(torch, d) for d in GEMM_DTYPES]
    n, routes = 0, Counter()

    def check(what, out, want, dtype):
        nonlocal n
        torch.cuda.synchronize()
        err, ok = max_error(torch, out, want, dtype)
        if not ok:
            fail(f"{what}: max |err| {err}")
        n += 1

    cases = [(kind, shape, col) for _, kind, shape, col, _ in TIMED_SHAPES]
    cases += [(kind, shape, False) for kind, shape in RAGGED_SHAPES]
    cases += [("mm", (61, 126, 37), True)]
    for dtype in dtypes:
        for kind, shape, col in cases:
            a, b = operands(torch, gen, kind, shape, dtype, col)
            fn, tiles = kernel_call(kind, shape, dtype, a, b)
            plain = ref.mm if kind == "mm" else ref.bmm
            check(f"{kind}{shape} {dtype} {describe(tiles.tile)}", fn(a, b),
                  plain(a, b), dtype)
            routes[describe(tiles.tile).split()[0]] += 1
            del a, b
    # the skinny kernel at M = 1..16 and both layouts, K split unevenly
    sn, sk = SKINNY_NK
    for dtype in dtypes:
        for m in range(1, 17):
            for col in (False, True):
                a, b = operands(torch, gen, "mm", (m, sn, sk), dtype, col)
                tile = runtime.gemm_tile(a, b, (16, 32, 32))
                if not isinstance(tile, runtime.SkinnyTile) or \
                        sk % tile.split == 0:
                    fail(f"mm({m},{sn},{sk}) {dtype}: {tile} is not an "
                         f"uneven skinny split")
                check(f"mm({m},{sn},{sk}) {dtype} col_major={col} "
                      f"{describe(tile)}", widesa_mm.matmul(a, b, tiles=tile),
                      ref.mm(a, b), dtype)
    # a B one element off its 16-byte boundary takes the tiled kernel
    for dtype in dtypes:
        a = draw(torch, gen, (4, 64), dtype)
        b = draw(torch, gen, (64 * 130 + 1,), dtype)[1:].view(64, 130)
        tile = runtime.gemm_tile(a, b, (4, 32, 32))
        want_tiled = runtime.b_copy_bytes(b) < 4
        before = dict(widesa_mm.variants)
        check(f"misaligned mm(4,130,64) {dtype} {describe(tile)}",
              widesa_mm.matmul(a, b, tiles=tile), ref.mm(a, b), dtype)
        went = "tiled" if widesa_mm.variants["tiled"] > before["tiled"] \
            else "skinny"
        if went != ("tiled" if want_tiled else "skinny"):
            fail(f"misaligned mm {dtype} (B copies of "
                 f"{runtime.b_copy_bytes(b)} bytes) ran {went}")
        routes[f"misaligned {str(dtype).removeprefix('torch.')} -> {went}"] \
            += 1
    # every compiled tile of the tiled kernel, including those no plan
    # picks, on a ragged mm (column-major B) and a ragged bmm
    for tiles in build.COMPILED_TILES:
        for dtype in dtypes:
            for kind, shape, col in (("mm", (61, 126, 37), True),
                                     ("bmm", (3, 61, 126, 37), False)):
                a, b = operands(torch, gen, kind, shape, dtype, col)
                fn, plain = ((widesa_mm.matmul, ref.mm) if kind == "mm"
                             else (bmm.bmm, ref.bmm))
                check(f"{kind}{shape} {dtype} tile {tiles}",
                      fn(a, b, tiles=tiles), plain(a, b), dtype)
    # attention scores: bf16 operands, the fp32 accumulator flushed as is
    for _, kind, shape, *_ in MAIN_SHAPES:
        if kind != "bmm":
            continue
        a, b = operands(torch, gen, kind, shape, torch.bfloat16, False)
        fn, tiles = kernel_call(kind, shape, torch.bfloat16, a, b,
                                torch.float32)
        check(f"bmm{shape} bf16->fp32 {describe(tiles.tile)}", fn(a, b),
              ref.bmm(a, b, torch.float32), torch.float32)
    # the cluster adds partial tiles in a fixed order: the same bits twice
    same = []
    for kind, shape in (("mm", (4, 1024, 2816)), ("mm", (12, 1024, 1024)),
                        ("bmm", (32, 1, 64, 1500))):
        for dtype in (torch.bfloat16, torch.float32):
            a, b = operands(torch, gen, kind, shape, dtype, False)
            fn, tiles = kernel_call(kind, shape, dtype, a, b)
            if tiles.tile.split < 2:
                fail(f"{kind}{shape} {dtype}: no split ({tiles.tile})")
            first, again = fn(a, b), fn(a, b)
            torch.cuda.synchronize()
            if not torch.equal(first, again):
                fail(f"{kind}{shape} {dtype} {describe(tiles.tile)}: two "
                     f"runs differ")
            same.append(f"{kind}{shape} {str(dtype).removeprefix('torch.')} "
                        f"split {tiles.tile.split}")
    print(f"kernels: GEMM parity ok in {n} cases (5 dtypes x "
          f"{len(cases)} serving/ragged shapes on the runtime's pick, "
          f"skinny at M = 1..16 x 2 layouts at (N, K) = {SKINNY_NK}, a "
          f"misaligned B, every compiled tile x 2 ragged shapes, bf16->fp32 "
          f"bmm): integers bit-exact, fp32 <= 1e-3, bf16 <= 2^-7|ref| + "
          f"1e-3; routes {dict(routes)}; bitwise equal on two runs: "
          f"{same}", flush=True)


#: the (input, output) dtypes of the tensor-core kernels: bf16 to bf16, bf16
#: to fp32 (the attention scores), float32 (3xTF32); int8, int16 and int32
#: to int32 (as int8 limbs)
TC_DTYPES = (("bfloat16", None), ("bfloat16", "float32"),
             ("float32", None), ("int8", None), ("int16", None),
             ("int32", None))


def tc_cases():
    """(kind, shape, A in padded rows) of the tensor-core parity cases:
    every prefill GEMM of a prompt of ``TC_PROMPTS`` tokens (the values'
    A padded, as the attention layer pads it), quickstart's 1024^3, the
    ragged shapes."""
    cases = [(kind, shape, padded_site(site)) for p in TC_PROMPTS
             for site, kind, shape, _, _ in prefill_shapes(p)]
    return cases + [(*QUICKSTART, False),
                    *((kind, shape, False) for kind, shape in TC_RAGGED)]


def tc_parity(torch) -> None:
    """The tensor-core kernels against their plain version (``tc_cases``)
    in bf16 -> bf16, bf16 -> fp32, float32 and the three integer dtypes,
    each B layout, on the configuration the runtime picks: ``wgmma``
    wherever TMA can address the operands or they are integers,
    ``wgmma_cp`` where a float operand TMA cannot address allows 8- or
    4-byte copies (else the tiled kernel), every launch counted there;
    two runs of split-K products bitwise equal; a one-TF32 control (the
    plain version with TF32 GEMMs) must fail float32's atol at
    quickstart's 1024^3."""
    from collections import Counter

    from repro_torch.kernels import bmm, ref, runtime, widesa_mm

    gen = torch.Generator(device="cuda").manual_seed(10)
    n, routes, worst = 0, Counter(), {}
    for kind, shape, pad in tc_cases():
        for in_name, out_name in TC_DTYPES:
            dtype = getattr(torch, in_name)
            out_dtype = out_name and getattr(torch, out_name)
            for col in (False, True):
                a, b = operands(torch, gen, kind, shape, dtype, col)
                if pad:
                    a = padded(torch, a)
                fn, tiles = kernel_call(kind, shape, dtype, a, b, out_dtype)
                # floats by the rows' alignment (``tc_kernel``: fresh
                # operands, A's rows padded or K long, B's K or N); the
                # integers' limb pre-pass reads any
                size = dtype.itemsize
                want_kernel = tc_kernel(
                    16 if pad else runtime.copy_bytes(0, size * shape[-1]),
                    runtime.copy_bytes(0, size * shape[-1 if col else -2])) \
                    if dtype.is_floating_point else "wgmma"
                mod = widesa_mm if kind == "mm" else bmm
                before = dict(mod.variants)
                out = fn(a, b)
                plain = ref.mm if kind == "mm" else ref.bmm
                want = plain(a, b, out_dtype)
                torch.cuda.synchronize()
                went = [v for v in mod.variants
                        if mod.variants[v] != before[v]]
                label = (f"{kind}{shape} {in_name}->{out_name or in_name} "
                         f"col_major={col}{' A padded' if pad else ''} "
                         f"{describe(tiles.tile, kind, shape)}")
                if went != [want_kernel]:
                    fail(f"{label}: ran {went}, the operands call for "
                         f"{want_kernel}")
                err, ok = max_error(torch, out, want, out.dtype)
                if not ok:
                    fail(f"{label}: max |err| {err}")
                key = f"{in_name}->{out_name or in_name}"
                worst[key] = max(worst.get(key, 0.0), err)
                routes[want_kernel] += 1
                n += 1
                del a, b, out, want
    same = []
    for kind, shape in (("mm", (512, 1024, 1024)), ("bmm", (16, 512, 64, 512)),
                        QUICKSTART):
        for dtype in (torch.bfloat16, torch.float32, torch.int8, torch.int16,
                      torch.int32):
            a, b = operands(torch, gen, kind, shape, dtype, False)
            fn, tiles = kernel_call(kind, shape, dtype, a, b)
            if not isinstance(tiles.tile, runtime.TcTile):
                fail(f"{kind}{shape} {dtype}: not on the tensor-core kernel")
            first, again = fn(a, b), fn(a, b)
            torch.cuda.synchronize()
            if not torch.equal(first, again):
                fail(f"{kind}{shape} {dtype} {describe(tiles.tile)}: two runs "
                     "differ")
            same.append(f"{kind}{shape} {str(dtype).removeprefix('torch.')} "
                        f"split {tiles.tile.split}")
    # one TF32 product: the plain version with TF32 GEMMs must fail
    a, b = operands(torch, gen, *QUICKSTART, torch.float32, False)
    want = ref.mm(a, b)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = ref.mm(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    err, ok = max_error(torch, control, want, torch.float32)
    if ok:
        fail(f"the one-TF32 control of {QUICKSTART} passes float32's atol "
             f"1e-3 (max |err| {err})")
    print(f"kernels: tensor-core GEMM parity ok in {n} cases (qwen prefill "
          f"GEMMs at P = {TC_PROMPTS} with the values' A in padded rows, "
          f"quickstart's {QUICKSTART[1]}, ragged {TC_RAGGED}; x "
          f"{len(TC_DTYPES)} dtype pairs x 2 B layouts): "
          f"launches by kernel {dict(routes)} (wgmma_cp: rows TMA cannot "
          f"address, by cp.async copies); max |err| by dtype {({k: f'{v:.4g}' for k, v in worst.items()})} "
          f"(fp32 <= 1e-3, bf16 <= 2^-7|ref| + 1e-3, integers exact); "
          f"bitwise equal on two "
          f"runs: {same}; one-TF32 control max |err| {err:.4g} > 1e-3 "
          f"(rejected)", flush=True)


def tc_timings(torch) -> dict:
    """The tensor-core kernel at the prefill shapes of a
    ``TC_TIMED_PROMPT``-token prompt (bf16; the scores flush to fp32) and
    at quickstart's float32 1024^3: ``torch.profiler`` device time of the
    kernel on the runtime's configuration, of the tiled kernel at the
    tile the plan maps to and of ``torch.matmul``/``torch.bmm``, beside
    the bound (bf16 at 989 TFLOP/s, float32 at 495/3 TFLOP/s: three TF32
    products a product) and the host time of a wrapper call.  The weight
    GEMMs read B over a rotation of ``COLD_BYTES``."""
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = {}
    timed = [(site, kind, shape, col, n, "bfloat16")
             for site, kind, shape, col, n in prefill_shapes(TC_TIMED_PROMPT)]
    timed.append(("quickstart", *QUICKSTART, False, 0, "float32"))
    for site, kind, shape, col, _, dname in timed:
        dtype = getattr(torch, dname)
        out_dtype = torch.float32 if "scores" in site else None
        a, bs = rotation(torch, gen, kind, shape, col, dtype)
        b = bs[0]
        fn, tiles = kernel_call(kind, shape, dtype, a, b, out_dtype)
        tiled, tile = tiled_call(kind, shape, dtype, col, out_dtype)
        lib = torch.matmul if kind == "mm" else torch.bmm

        def library(x, y):
            return lib(x, y) if out_dtype is None else lib(x, y, out_dtype)

        out = fn(a, b)
        plain = ref.mm if kind == "mm" else ref.bmm
        err, _ = max_error(torch, out, plain(a, b, out_dtype), out.dtype)
        reps = max(10, len(bs))
        row = dict(
            tiles=tiles, tiled_tile=tile, max_abs_err=err,
            device_ms=device_ms(torch, cycling(fn, a, bs), "gemm_tc_kernel",
                                reps),
            tiled_device_ms=device_ms(torch, cycling(tiled, a, bs),
                                      "gemm_kernel", reps),
            library_device_ms=device_ms(torch, cycling(library, a, bs), None,
                                        reps),
            plain_ms=time_ms(torch, lambda: plain(a, b, out_dtype)),
            host_us=host_us(torch, cycling(fn, a, bs)),
        )
        if dname == "float32":  # three TF32 products a product
            m, n, k = shape
            row["bound_ms"], row["bound_by"] = least_ms(
                (m * k + k * n + m * n) * 4, 3 * 2 * m * n * k, "tfloat32")
        else:
            row["bound_ms"], row["bound_by"] = bound_ms(
                kind, shape, 2, out.element_size(), "bfloat16")
        rows[(kind, shape, col)] = row
        lib_name = f"torch.{lib.__name__}"
        print(f"time {kind}{shape} {dname}{'->fp32' if out_dtype else ''} "
              f"[{site}] {describe(tiles.tile, kind, shape)}"
              f"{', B column-major' if col else ''}: device (profiler; "
              f"{len(bs)} B operand(s)) wgmma {fmt_ms(row['device_ms'])}, "
              f"tiled {tile} {fmt_ms(row['tiled_device_ms'])}, {lib_name} "
              f"{fmt_ms(row['library_device_ms'])}, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}"
              f"{', 3xTF32' if dname == 'float32' else ''}); plain "
              f"{row['plain_ms']:.4f} ms (CUDA events); host per wrapper "
              f"call {row['host_us']:.1f} us; max |err| {err:.4g}",
              flush=True)
        del a, b, bs, out
    per = {key: sum(n * (rows[(kind, shape, col)][key] or 0.0)
                    for _, kind, shape, col, n in
                    prefill_shapes(TC_TIMED_PROMPT))
           for key in ("device_ms", "tiled_device_ms", "library_device_ms",
                       "bound_ms")}
    print(f"time: the {sum(s[-1] for s in prefill_shapes(TC_TIMED_PROMPT))} "
          f"GEMMs above 16 rows of a {TC_TIMED_PROMPT}-token qwen prefill, "
          f"summed from the device times above: wgmma "
          f"{per['device_ms']:.4f} ms, tiled {per['tiled_device_ms']:.4f} ms, "
          f"library {per['library_device_ms']:.4f} ms, bound "
          f"{per['bound_ms']:.4f} ms", flush=True)
    return rows


#: report sites whose shapes are not one GEMM: the frontend's FIR, conv2d
#: and fft2d chain (held in phase 3) and the MLP pair's ``xla`` stamp
NON_GEMM_SITES = ("frontend.", "mlp.pair")


def drain_parity(torch, report, path: str, tied: bool = True) -> None:
    """Every GEMM shape a serving drain gave a site (``planned_report``),
    through the hand kernel on the configuration the runtime picks against
    the plain version, in bf16 (the serving dtype; float32 at the MoE
    router), in the drain's layouts: the tied lm_head and the scores read
    B column-major, the values their A in padded rows; the score sites
    flush to fp32.
    Run after the drain's counts are read, so these launches count for
    no path."""
    from collections import Counter

    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = sorted({(site, ast.literal_eval(key))
                    for site, st in report.items()
                    if not site.startswith(NON_GEMM_SITES)
                    for key in st["shapes"]})
    worst, routes = 0.0, Counter()
    for site, shape in cases:
        kind = "mm" if len(shape) == 3 else "bmm"
        col = col_major_site(site, shape, tied)
        dtype = getattr(torch, site_dtype(site))
        out_dtype = torch.float32 if "scores" in site else None
        a, b = operands(torch, gen, kind, shape, dtype, col)
        if padded_site(site):
            a = padded(torch, a)
        fn, tiles = kernel_call(kind, shape, dtype, a, b, out_dtype)
        plain = ref.mm if kind == "mm" else ref.bmm
        out, want = fn(a, b), plain(a, b, out_dtype)
        torch.cuda.synchronize()
        err, ok = max_error(torch, out, want, out.dtype)
        if not ok:
            fail(f"{path}: {site} {kind}{shape} {dtype} "
                 f"{describe(tiles.tile)}: max |err| {err}")
        worst = max(worst, err)
        routes[describe(tiles.tile).split()[0]] += 1
        del a, b, out, want
    print(f"{path}: the {len(cases)} GEMM (site, shape) pairs of the drain "
          f"match the plain versions in bf16"
          f"{' (the MoE router in float32)' if 'moe.router' in report else ''}"
          f" on the runtime's configuration ({dict(routes)}; bf16 <= "
          f"2^-7|ref| + 1e-3, fp32 scores and router <= 1e-3; "
          f"max |err| {worst:.4g}): {sorted({s for s, _ in cases})}",
          flush=True)


def drains_parity(torch, run, prun, path: str, tied: bool = True) -> None:
    """``drain_parity`` over the (site, shape) pairs of a slot drain
    ``run`` and a paged drain ``prun`` together."""
    merged = {s: {"shapes": {**run["report"].get(s, {}).get("shapes", {}),
                             **prun["report"].get(s, {}).get("shapes", {})}}
              for s in {*run["report"], *prun["report"]}}
    drain_parity(torch, merged, path, tied)


def time_ms(torch, fn, reps=50, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(torch, fn, kernel=None, reps=10, launches=1):
    """Device time per call of ``fn`` from ``torch.profiler`` over ``reps``
    calls; None if four traces recorded nothing.  With ``kernel``: the
    mean time of the CUDA kernel records whose name holds ``kernel``,
    times ``launches`` (those kernels a call), since the profiler can drop
    device records (all of a kernel's in a trace, now and then: hence the
    further traces) and each record it keeps is one launch's time.
    Without: every device event of the trace, over ``reps``.  Unlike
    ``time_ms`` this leaves out the host's launch overhead, which back-to-
    back launches of a short kernel measure instead of the kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evts = [evt for evt in prof.key_averages()
                if kernel is None or kernel in evt.key]
        us = sum(getattr(evt, "self_device_time_total", 0.0) for evt in evts)
        if us:
            break
    else:
        return None
    if kernel is None:
        return us / reps / 1e3
    return us / sum(evt.count for evt in evts) * launches / 1e3


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def least_ms(moved, ops, dtype_name):
    """The larger of ``moved`` bytes at the HBM rate and ``ops``
    operations at the peak rate of ``dtype_name``, with what bounds it."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(kind, shape, in_bytes, out_bytes, dtype_name):
    """Least time for the work: each input read once and the output
    written once at the HBM rate, or the multiply-adds at the peak rate
    of the operand type, whichever is larger."""
    if kind == "mm":
        (m, n, k), z = shape, 1
    else:
        z, m, n, k = shape
    moved = z * ((m * k + k * n) * in_bytes + m * n * out_bytes)
    return least_ms(moved, 2 * z * m * n * k, dtype_name)


def host_us(torch, fn, calls=200) -> float:
    """Host time of one call of ``fn`` in microseconds: ``calls`` back-to-
    back calls on the host clock, with no synchronisation between them
    (what the Python side costs a launch while the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def host_profile(torch, label, fn, calls=500, top=8) -> None:
    """Where the host time of ``fn`` goes: ``cProfile`` over ``calls``
    back-to-back calls, the ``top`` functions by their own time."""
    import cProfile
    import pstats

    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:top]
    total = sum(v[2] for v in stats.stats.values()) / calls * 1e6
    parts = ", ".join(f"{name}:{line} {v[2] / calls * 1e6:.1f}"
                      for (path, line, name), v in rows)
    print(f"host profile of {label} (cProfile, {calls} calls, us a call, "
          f"profiler overhead included): total {total:.1f}; by own time: "
          f"{parts}", flush=True)


def rotation(torch, gen, kind, shape, col, dtype):
    """A, and distinct B operands totalling at least ``COLD_BYTES`` (two at
    least) for an mm, so that no launch finds its B in the L2; one B for a
    bmm."""
    a, b = operands(torch, gen, kind, shape, dtype, col)
    bs = [b]
    if kind == "mm":
        copies = max(2, math.ceil(COLD_BYTES / (b.numel() * b.element_size())))
        bs += [operands(torch, gen, kind, shape, dtype, col)[1]
               for _ in range(copies - 1)]
    return a, bs


def cycling(fn, a, bs):
    """``fn(a, b)`` over the B operands ``bs`` in turn."""
    turn = itertools.cycle(bs)
    return lambda: fn(a, next(turn))


def timings(torch) -> dict:
    """The GEMMs at the timed shapes in bf16 (the serving dtype; scores
    flush to fp32): the skinny kernel on the runtime's configuration, the
    tiled kernel at its tile, ``torch.matmul``/``torch.bmm`` and
    the bound, with ``torch.profiler`` device time (the mm rows over
    distinct B operands totalling ``COLD_BYTES``, read cold from HBM),
    CUDA-event times of back-to-back calls (the host's launch rate where
    it is slower than the card), and the host time of a wrapper call and
    of a planned-facade call."""
    from repro_torch.kernels import planned, ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for site, kind, shape, col, _ in TIMED_SHAPES:
        out_dtype = torch.float32 if "scores" in site else None
        a, bs = rotation(torch, gen, kind, shape, col, torch.bfloat16)
        b = bs[0]
        fn, tiles = kernel_call(kind, shape, torch.bfloat16, a, b, out_dtype)
        tiled, tile = tiled_call(kind, shape, torch.bfloat16, col, out_dtype)
        plain = ref.mm if kind == "mm" else ref.bmm
        lib = torch.matmul if kind == "mm" else torch.bmm

        def library(x, y):
            # torch.bmm's out_dtype is the same fp32 flush of bf16 inputs
            return lib(x, y) if out_dtype is None else lib(x, y, out_dtype)

        def facade(x, y):
            if kind == "mm":
                return planned.planned_dense(x, y, site="timing")
            return planned.planned_bmm(x, y, site="timing",
                                       out_dtype=out_dtype)

        out, want = fn(a, b), plain(a, b, out_dtype)
        err, _ = max_error(torch, out, want, out.dtype)
        reps = max(10, len(bs))
        row = dict(
            tiles=tiles, tiled_tile=tile, max_abs_err=err,
            cold=len(bs) > 1,
            device_ms=device_ms(torch, cycling(fn, a, bs), "skinny_kernel",
                                reps),
            tiled_device_ms=device_ms(torch, cycling(tiled, a, bs),
                                      "gemm_kernel", reps),
            library_device_ms=device_ms(torch, cycling(library, a, bs),
                                        None, reps),
            ms=time_ms(torch, cycling(fn, a, bs)),
            plain_ms=time_ms(torch, lambda: plain(a, b, out_dtype)),
            library_ms=time_ms(torch, cycling(library, a, bs)),
            host_us=host_us(torch, cycling(fn, a, bs)),
            facade_us=host_us(torch, cycling(facade, a, bs)),
        )
        row["bound_ms"], row["bound_by"] = bound_ms(
            kind, shape, 2, out.element_size(), "bfloat16")
        rows[(kind, shape, col)] = row
        lib_name = f"torch.{lib.__name__}"
        held = (f"{len(bs)} B operands of "
                f"{b.numel() * b.element_size() / 2**20:.1f} MiB, cold"
                if row["cold"] else "one B, warm")
        print(f"time {kind}{shape} bf16 [{site}] "
              f"{describe(tiles.tile, kind, shape)}{', B column-major' if col else ''}: device ({held}) "
              f"skinny {fmt_ms(row['device_ms'])}, tiled {tile} "
              f"{fmt_ms(row['tiled_device_ms'])}, {lib_name} "
              f"{fmt_ms(row['library_device_ms'])}, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); CUDA events: "
              f"skinny {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"{lib_name} {row['library_ms']:.4f} ms; host per call: "
              f"wrapper {row['host_us']:.1f} us, planned facade "
              f"{row['facade_us']:.1f} us", flush=True)
        if (kind, shape) == ("mm", (4, 1024, 1024)):
            host_profile(torch, f"the mm wrapper at {shape}",
                         cycling(fn, a, bs))
            host_profile(torch, f"planned_dense at {shape}",
                         cycling(facade, a, bs))
        del a, b, bs, out, want
    # the GEMM share of one decode step, from the per-shape device times
    step = {key: sum(n * (rows[(kind, shape, col)][key] or 0.0)
                     for _, kind, shape, col, n in MAIN_SHAPES)
            for key in ("device_ms", "tiled_device_ms", "library_device_ms",
                        "bound_ms")}
    print(f"time: the {sum(s[-1] for s in MAIN_SHAPES)} GEMMs of a 4-lane "
          f"qwen decode step, summed from the device times above: skinny "
          f"{step['device_ms']:.4f} ms, tiled "
          f"{step['tiled_device_ms']:.4f} ms, library "
          f"{step['library_device_ms']:.4f} ms, bound "
          f"{step['bound_ms']:.4f} ms", flush=True)
    slower = [f"{kind}{shape}" for (kind, shape, _), row in rows.items()
              if None not in (row["device_ms"], row["tiled_device_ms"])
              and row["device_ms"] > row["tiled_device_ms"]]
    print(f"time: shapes where the skinny kernel's device time is above the "
          f"tiled kernel's: {slower or 'none'}", flush=True)
    return rows


def tile_sweep(torch) -> list[dict]:
    """Every sweep tile of the tiled kernel, and every split of the skinny
    kernel, at every main-path shape, bf16 (profiler device time for the
    skinny kernel, CUDA events for the tiled one)."""
    from repro_torch.kernels import build, runtime

    gen = torch.Generator(device="cuda").manual_seed(3)
    tiles = build.SWEEP_TILES
    rows = []
    for site, kind, shape, col, _ in MAIN_SHAPES:
        a, b = operands(torch, gen, kind, shape, torch.bfloat16, col)
        fn = gemm_fn(kind)
        times = {t: time_ms(torch, lambda t=t: fn(a, b, tiles=t))
                 for t in tiles}
        picked = runtime.hopper_tiles(gemm_plan(kind, shape, torch.bfloat16),
                                      b_col_major=col).tile
        best = min(times, key=times.get)
        splits = skinny_splits(torch, kind, a, b)
        chosen = runtime.gemm_tile(a, b, picked)
        rows.append(dict(site=site, kind=kind, shape=shape, picked=picked,
                         best=best, times={str(t): ms
                                           for t, ms in times.items()},
                         skinny=str(chosen), splits=splits))
        print(f"sweep {kind}{shape} [{site}]: tiled picked {picked} "
              f"{times[picked]:.4f} ms, fastest {best} {times[best]:.4f} ms "
              f"(events); skinny {describe(chosen, kind, shape)}, device ms by "
              f"split {({s: round(v, 4) if v else v for s, v in splits.items()})}",
              flush=True)
        del a, b
    return rows


def skinny_splits(torch, kind, a, b) -> dict:
    """Device ms (profiler) of the skinny kernel on ``a @ b`` with each
    split of K over 1-8 blocks of a cluster that the kernel takes (no rank
    empty)."""
    from repro_torch.kernels import runtime

    fn = gemm_fn(kind)
    k = a.shape[-1]
    bk = runtime.skinny_bk(a.dtype)
    stages = -(-k // bk)
    splits = {}
    for split in range(1, min(runtime.SKINNY_MAX_CLUSTER, stages) + 1):
        kblk = -(-stages // split) * bk
        tile = runtime.SkinnyTile(split=-(-k // kblk), kblk=kblk)
        if tile.split == split:
            splits[split] = device_ms(
                torch, lambda t=tile: fn(a, b, tiles=t), "skinny_kernel")
    return splits


#: the skinny sweep: the MoE router's float32 GEMM at decode and short
#: prompts (B of 512 KB, 64 stages of K), the expert stack at decode,
#: small-B bf16 shapes the split rule leaves whole (whisper-base's d 512
#: projections at decode, qwen's decode values) and one it splits since
#: ``runtime.SKINNY_DEEP_STAGES`` (whisper-base's streaming encoder
#: values over 1024 frames: 16 stages of K, 16 blocks)
SKINNY_SWEEP = (
    ("moe.router, decode", "mm", (4, 64, 2048), "float32"),
    ("moe.router, 1 row", "mm", (1, 64, 2048), "float32"),
    ("moe.router, 16 rows", "mm", (16, 64, 2048), "float32"),
    ("moe.gate/up, decode", "bmm", (64, 1, 1024, 2048), "bfloat16"),
    ("moe.down, decode", "bmm", (64, 1, 2048, 1024), "bfloat16"),
    ("attn.q/k/v/out, whisper-base decode", "mm", (4, 512, 512),
     "bfloat16"),
    ("attn.decode_values, qwen", "bmm", (64, 1, 64, 128), "bfloat16"),
    ("attn.values, whisper-base encoder chunk", "bmm", (8, 8, 64, 1024),
     "bfloat16"),
)


def skinny_sweep(torch) -> list[dict]:
    """The skinny kernel at ``SKINNY_SWEEP`` with every split of K, beside
    the runtime's pick and ``torch.matmul``/``torch.bmm`` (profiler device
    time; the weight GEMMs of an mm over a rotation of ``COLD_BYTES`` of
    B for the library and the runtime's pick)."""
    from repro_torch.kernels import runtime

    gen = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    for site, kind, shape, dname in SKINNY_SWEEP:
        dtype = getattr(torch, dname)
        a, bs = rotation(torch, gen, kind, shape, False, dtype)
        b = bs[0]
        chosen = runtime.gemm_tile(a, b, (16, 32, 32))
        fn = gemm_fn(kind)
        lib = torch.matmul if kind == "mm" else torch.bmm
        reps = max(10, len(bs))
        picked = device_ms(torch, cycling(
            lambda x, y: fn(x, y, tiles=chosen), a, bs), "skinny_kernel",
            reps)
        library = device_ms(torch, cycling(lib, a, bs), None, reps)
        splits = skinny_splits(torch, kind, a, b)
        bound, by = bound_ms(kind, shape, dtype.itemsize, dtype.itemsize,
                             dname)
        rows.append(dict(site=site, kind=kind, shape=shape, dtype=dname,
                         picked=str(chosen), picked_ms=picked,
                         library_ms=library, bound_ms=bound, splits=splits))
        print(f"skinny sweep {kind}{shape} {dname} [{site}]: runtime's "
              f"{describe(chosen, kind, shape)} {fmt_ms(picked)} over "
              f"{len(bs)} B operand(s), torch.{lib.__name__} "
              f"{fmt_ms(library)}, bound {bound:.4f} ms ({by}); device ms "
              f"by split (one B) "
              f"{({s: round(v, 4) if v else v for s, v in splits.items()})}",
              flush=True)
        del a, b, bs
    return rows


# ---------------------------------------------------------------------------
# FIR, conv2d and fft2d
# ---------------------------------------------------------------------------

def sp_operands(torch, gen, name, args, dtype):
    """FIR (x [n + t - 1], h [t]) or conv2d (img [h+p-1, w+q-1],
    filt [p, q]) operands for the recurrence extents ``args``."""
    if name == "fir":
        n, t = args
        shapes = ((n + t - 1,), (t,))
    else:
        h, w, p, q = args
        shapes = ((h + p - 1, w + q - 1), (p, q))
    return [draw(torch, gen, s, dtype) for s in shapes]


def sp_kernel(name, args, dtype):
    """The FIR or conv2d wrapper at the tile the runtime picks from the
    planner's plan for this shape: (call, plain version, HopperTiles)."""
    from repro_torch.kernels import conv2d, fir, planned, ref, runtime

    plan = planned.plan_for(name, args, planned.dtype_name(dtype))
    if plan is None:
        fail(f"no feasible plan for {name}{args} {dtype}")
    if name == "fir":
        tiles = runtime.fir_tile(plan, args[0])
        return (lambda a, b: fir.fir(a, b, tiles=tiles.tile)), ref.fir, tiles
    tiles = runtime.conv2d_tile(plan, args[0], args[1])
    return ((lambda a, b: conv2d.conv2d(a, b, tiles=tiles.tile)),
            ref.conv2d, tiles)


def fft_kernel(shape=FFT_MAIN):
    """The fft2d wrapper on the form the runtime routes an fft2d_stage
    plan of ``shape`` to (the fused kernel up to 64 rows, the FFT kernel
    above where both sides are powers of two), and the composition over
    the GEMMs on the plan's tiled tile: (routed call, composition call,
    the routed tile)."""
    import torch

    from repro_torch.kernels import fft2d, planned, registry, runtime

    plan = planned.plan_for("fft2d_stage", shape, "float32")
    if plan is None:
        fail(f"no feasible plan for fft2d_stage{shape}")
    x = torch.empty(shape, device="cuda")
    tile = registry.get("fft2d_stage").tiles(plan, x, x).tile
    tiled = runtime.hopper_tiles(plan).tile
    return ((lambda re_, im_: fft2d.fft2d(re_, im_, tiles=tile)),
            (lambda re_, im_: fft2d.fft2d(re_, im_, tiles=tiled)), tile)


def sp_parity(torch) -> None:
    """FIR and conv2d against their plain versions in every dtype they
    take, at the frontend and ragged shapes, with every compiled tile
    (the picked one among them); the fused fft2d kernel at ``FFT_SHAPES``
    and the composition at the frontend tile against ``ref.fft2d``."""
    from repro_torch.kernels import build, conv2d, fir, ref, runtime

    gen = torch.Generator(device="cuda").manual_seed(4)
    dtypes = (torch.float32, torch.int8, torch.int16, torch.int32)
    n = 0
    for name, fn, plain in (("fir", fir.fir, ref.fir),
                            ("conv2d", conv2d.conv2d, ref.conv2d)):
        for args in (SP_MAIN[name], *SP_RAGGED[name]):
            for dtype in dtypes:
                a, b = sp_operands(torch, gen, name, args, dtype)
                want = plain(a, b)
                picked = sp_kernel(name, args, dtype)[2].tile
                if name == "fir":
                    # the tap count's instantiation (the generic one for
                    # others), and the generic one on the same operands
                    if picked.taps != runtime.fir_config(*args).taps:
                        fail(f"fir{args}: picked {picked}")
                    generic = runtime.fir_config(
                        *args, a.element_size(), compiled=build.FIR_GENERIC)
                    tiles = [picked] if picked == generic \
                        else [picked, generic]
                else:
                    # the window the runtime picks, and the generic
                    # instantiation on the same operands
                    if picked.window != runtime.conv2d_window(*args[2:]):
                        fail(f"conv2d{args}: picked {picked}")
                    generic = runtime.conv2d_config(
                        *args[2:], *args[:2], window=build.CONV2D_GENERIC)
                    tiles = [picked] if picked == generic \
                        else [picked, generic]
                for tile in tiles:
                    out = fn(a, b, tiles=tile)
                    torch.cuda.synchronize()
                    err, ok = max_error(torch, out, want, dtype)
                    if not ok:
                        fail(f"{name}{args} {dtype} tile {tile}: max |err| "
                             f"{err}")
                    n += 1
    n += fir_extra_parity(torch, gen, dtypes)
    worst = 0.0
    for shape in FFT_SHAPES:
        fused, composition, tile = fft_kernel(shape)
        if not isinstance(tile, runtime.Fft2dTile):
            fail(f"fft2d{shape} routed to the composition ({tile})")
        re_, im_ = (torch.randn(shape, generator=gen, device="cuda")
                    for _ in range(2))
        want = ref.fft2d(re_, im_)
        calls = [("fused", fused)]
        if shape == FFT_MAIN:
            calls.append(("composition", composition))
        for form, call in calls:
            got = call(re_, im_)
            torch.cuda.synchronize()
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            if err > 1.0:
                fail(f"fft2d{shape} {form}: max |err| {err} > 1.0")
            if form == "fused":
                worst = max(worst, err)
                again = call(re_, im_)
                if not all(torch.equal(g, a) for g, a in zip(got, again)):
                    fail(f"fft2d{shape} fused {tile}: two runs differ")
            n += 1
    print(f"kernels: FIR/conv2d/fft2d parity ok in {n} cases (FIR: 4 "
          f"dtypes x the frontend's and ragged shapes {SP_RAGGED['fir']} on "
          f"the tap count's instantiation (15; int8 on __dp4a) and the "
          f"generic one, fir_complex at the same shapes in one launch each, "
          f"x as a view {FIR_OFFSETS} elements into its storage; "
          f"conv2d: 4 dtypes x the frontend's 5 x 4 and ragged shapes on "
          f"every compiled window (4 x 4, 8 x 8, 5 x 4; int8 on __dp4a) and "
          f"the generic instantiation (1 x 1, 3 x 5, 12 x 7, 32 x 32, and beside "
          f"each compiled case); integers bit-exact (full-range operands), "
          f"fp32 <= 1e-3; fft2d: the fused kernel "
          f"at {list(FFT_SHAPES)} and the composition at {FFT_MAIN}, <= "
          f"1.0, the fused kernel's max |err| {worst:.4g}, two runs "
          f"bitwise equal)", flush=True)


#: the misaligned-B check's shape: A [4, 64], B [64, 130] one element off
#: its 16-byte boundary (bf16 rows allow no 4-byte copy: the tiled kernel)
MISALIGNED_MM = (4, 130, 64)


def tiled_timing(torch) -> dict:
    """The tiled ``gemm_kernel`` at ``MISALIGNED_MM`` in bf16, one of the
    two cases it keeps (``runtime.tiled_reason``): profiler device time
    beside its bound, the plain version and ``torch.matmul`` on the same
    operands."""
    from repro_torch.kernels import ref, runtime, widesa_mm

    gen = torch.Generator(device="cuda").manual_seed(33)
    m, n, k = MISALIGNED_MM
    a = draw(torch, gen, (m, k), torch.bfloat16)
    b = draw(torch, gen, (k * n + 1,), torch.bfloat16)[1:].view(k, n)
    tile = runtime.gemm_tile(a, b, (4, 32, 32))
    before = widesa_mm.variants["tiled"]
    out = widesa_mm.matmul(a, b, tiles=tile)
    err, ok = max_error(torch, out, ref.mm(a, b), torch.bfloat16)
    if widesa_mm.variants["tiled"] != before + 1 or not ok:
        fail(f"misaligned mm{MISALIGNED_MM} bf16 {describe(tile)}: "
             f"max |err| {err}, tiled launches "
             f"{widesa_mm.variants['tiled'] - before}")
    row = dict(tile=str(tile), max_abs_err=err,
               ms=time_ms(torch, lambda: widesa_mm.matmul(a, b, tiles=tile)),
               device_ms=device_ms(torch, lambda: widesa_mm.matmul(
                   a, b, tiles=tile), "gemm_kernel", 20),
               plain_ms=time_ms(torch, lambda: ref.mm(a, b)),
               library_ms=time_ms(torch, lambda: torch.matmul(a, b)),
               library_device_ms=device_ms(
                   torch, lambda: torch.matmul(a, b), None, 20))
    row["bound_ms"], row["bound_by"] = bound_ms("mm", MISALIGNED_MM, 2, 2,
                                                "bfloat16")
    print(f"time mm{MISALIGNED_MM} bf16, B one element off its 16-byte "
          f"boundary [tiled gemm_kernel {describe(tile)}]: {row['ms']:.4f} "
          f"ms (device {fmt_ms(row['device_ms'])}), bound "
          f"{row['bound_ms']:.7f} ms ({row['bound_by']}), plain "
          f"{row['plain_ms']:.4f} ms, torch.matmul {row['library_ms']:.4f} "
          f"ms (device {fmt_ms(row['library_device_ms'])}); max |err| "
          f"{err:.4g}", flush=True)
    return row


def fft_parity(torch) -> None:
    """The FFT kernel (both passes) at ``FFT_KERNEL_SHAPES`` on the tile
    the runtime routes each to, and at 8192^2 also on 8-column strips
    over the portable cluster of 8: within the registry's atol of
    ``ref.fft2d``,
    two runs bitwise equal, and held to its plain version
    (``fft2d.fft_plain``, which rounds each product and sum as the kernel
    does: equal to the last bit, the count of shapes where it is not
    printed)."""
    from repro_torch.kernels import fft2d, ref, runtime

    gen = torch.Generator(device="cuda").manual_seed(34)
    cases = [(shape, fft_kernel(shape)[2]) for shape in FFT_KERNEL_SHAPES]
    cases.append(((8192, 8192), runtime.fft_config(8192, 8192, strip=8)))
    worst, plain_worst, unequal = 0.0, 0.0, []
    for shape, tile in cases:
        if not isinstance(tile, runtime.FftTile) \
                or not runtime.fft_allows(*shape, tile):
            fail(f"fft2d{shape}: routed to {tile}, not the FFT kernel")
        re_, im_ = (torch.randn(shape, generator=gen, device="cuda")
                    for _ in range(2))
        got = fft2d.fft2d(re_, im_, tiles=tile)
        again = fft2d.fft2d(re_, im_, tiles=tile)
        torch.cuda.synchronize()
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            fail(f"fft2d{shape} {tile}: two runs differ")
        del again
        err = max((g - w).abs().max().item()
                  for g, w in zip(got, ref.fft2d(re_, im_)))
        plain = fft2d.fft_plain(re_, im_, tile)
        perr = max((g - w).abs().max().item() for g, w in zip(got, plain))
        if not all(torch.equal(g, w) for g, w in zip(got, plain)):
            unequal.append(shape)
        if err > 1.0 or perr > 1.0:
            fail(f"fft2d{shape} {tile}: max |err| {err} against "
                 f"torch.fft.fft2, {perr} against the plain version")
        worst, plain_worst = max(worst, err), max(plain_worst, perr)
        del re_, im_, got, plain
        torch.cuda.empty_cache()
    print(f"kernels: fft2d's FFT kernel (fft_pass_kernel, row and column "
          f"passes) ok in {len(cases)} cases {[c[0] for c in cases]} "
          f"(8192^2 also on 8-column strips over a cluster of 8): max "
          f"|err| {worst:.4g} against torch.fft.fft2 (atol 1.0), "
          f"{plain_worst:.4g} against its plain version, bitwise unequal "
          f"at {unequal or 'no shape'}; two runs bitwise equal", flush=True)


def fir_extra_parity(torch, gen, dtypes) -> int:
    """``fir_complex`` (one launch a call) against ``ref.fir_complex`` at
    the frontend's and ragged shapes, and the real FIR of an ``x`` that
    starts ``FIR_OFFSETS`` elements into its storage, in every dtype; the
    number of cases."""
    from repro_torch.kernels import fir, ref

    n = 0
    for args in (SP_MAIN["fir"], *SP_RAGGED["fir"]):
        for dtype in dtypes:
            (xr, hr), (xi, hi) = (sp_operands(torch, gen, "fir", args, dtype)
                                  for _ in range(2))
            before = fir.launches
            got = fir.fir_complex(xr, xi, hr, hi)
            torch.cuda.synchronize()
            if fir.launches != before + 1:
                fail(f"fir_complex{args} {dtype}: "
                     f"{fir.launches - before} launches")
            for g, w in zip(got, ref.fir_complex(xr, xi, hr, hi)):
                err, ok = max_error(torch, g, w, dtype)
                if not ok:
                    fail(f"fir_complex{args} {dtype}: max |err| {err}")
            n += 1
    for offset in FIR_OFFSETS:
        for args in (SP_MAIN["fir"], SP_RAGGED["fir"][0]):
            for dtype in dtypes:
                size, taps = args[0] + args[1] - 1, args[1]
                x = draw(torch, gen, (size + offset,), dtype)[offset:]
                h = draw(torch, gen, (taps,), dtype)
                call, plain, _ = sp_kernel("fir", args, dtype)
                err, ok = max_error(torch, call(x, h), plain(x, h), dtype)
                if not ok:
                    fail(f"fir{args} {dtype}, x {offset} elements into its "
                         f"storage: max |err| {err}")
                n += 1
    return n


def sp_bound_ms(name, args, in_bytes, out_bytes, dtype):
    """Least time for one FIR or conv2d call (see ``least_ms``): the
    operations at the card's int8 rate for int8 operands, else at the fp32
    CUDA-core rate."""
    if name == "fir":
        n, t = args
        moved = (n + 2 * t - 1) * in_bytes + n * out_bytes
        ops = 2 * n * t
    else:
        h, w, p, q = args
        moved = ((h + p - 1) * (w + q - 1) + p * q) * in_bytes \
            + h * w * out_bytes
        ops = 2 * h * w * p * q
    return least_ms(moved, ops,
                    "int8" if dtype == "torch.int8" else "float32")


def fir_complex_timing(torch, gen) -> dict:
    """``fir_complex`` at FIR's bench shape in float32 (one launch) beside
    ``ref.fir_complex`` (four passes and the combines), one ``F.conv1d``
    computing the same function (two input channels, the planes, and two
    output channels, weights (h_re, -h_im) and (h_im, h_re); TF32 off), the
    four real ``F.conv1d`` calls and the combines, a ``copy_`` of the same
    bytes (both planes) and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import fir, ref, runtime

    n, t = SP_BENCH["fir"]
    (xr, hr), (xi, hi) = (sp_operands(torch, gen, "fir", (n, t),
                                      torch.float32) for _ in range(2))
    tiles = runtime.fir_config(n, t, 4, planes=2)
    before = fir.launches
    got = fir.fir_complex(xr, xi, hr, hi, tiles=tiles)
    launched = fir.launches - before
    want = ref.fir_complex(xr, xi, hr, hi)
    err = max(max_error(torch, g, w, torch.float32)[0]
              for g, w in zip(got, want))
    if launched != 1 or err > 1e-3:
        fail(f"fir_complex{(n, t)}: {launched} launches, max |err| {err}")
    planes = torch.stack([xr, xi])[None]
    weight = torch.stack([torch.stack([hr, -hi]), torch.stack([hi, hr])])

    def four(xr=xr, xi=xi, hr=hr, hi=hi):
        def c(x, h):
            return F.conv1d(x[None, None], h[None, None])[0, 0]
        return c(xr, hr) - c(xi, hi), c(xr, hi) + c(xi, hr)

    lib = F.conv1d(planes, weight)[0]
    lib_err = max((lib[i] - want[i]).abs().max().item() for i in range(2))
    if lib_err > 1e-3:
        fail(f"fir_complex{(n, t)}: F.conv1d's max |err| {lib_err}")

    def copy(o=got, x=(xr, xi)):
        o[0].copy_(x[0][:n])
        o[1].copy_(x[1][:n])

    row = dict(
        tiles=tiles, launches=launched, max_abs_err=err,
        ms=time_ms(torch, lambda: fir.fir_complex(xr, xi, hr, hi,
                                                  tiles=tiles), 10),
        plain_ms=time_ms(torch, lambda: ref.fir_complex(xr, xi, hr, hi), 3,
                         1),
        library_ms=time_ms(torch, lambda: F.conv1d(planes, weight), 10),
        device_ms=device_ms(torch, lambda: fir.fir_complex(
            xr, xi, hr, hi, tiles=tiles), "fir_kernel", 50),
        library_device_ms=device_ms(torch,
                                    lambda: F.conv1d(planes, weight)),
        four_conv1d_device_ms=device_ms(torch, four),
        copy_device_ms=device_ms(torch, copy, None, 50),
    )
    # both planes of x and h read once, both planes of y written once; the
    # four real products' 8 n t operations
    row["bound_ms"], row["bound_by"] = least_ms(
        2 * (n + 2 * t - 1) * 4 + 2 * n * 4, 8 * n * t, "float32")
    print(f"time fir_complex{(n, t)} float32 [bench, one launch] -> "
          f"{tiles}: kernel {row['ms']:.4f} ms, plain (four passes) "
          f"{row['plain_ms']:.4f} ms, F.conv1d (2 -> 2 channels) "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}); device time (profiler): kernel "
          f"{fmt_ms(row['device_ms'])}, F.conv1d "
          f"{fmt_ms(row['library_device_ms'])}, four F.conv1d and the "
          f"combines {fmt_ms(row['four_conv1d_device_ms'])}, a copy_ of "
          f"the same bytes {fmt_ms(row['copy_device_ms'])}; max |err| "
          f"{err:.4g} (F.conv1d {lib_err:.4g})", flush=True)
    return row


def sp_timings(torch) -> dict:
    """FIR and conv2d at the main-path shape and dtype (the whisper-base
    frontend, int16), each at its bench cases (the paper's FIR and conv2d
    tables; FIR's cfloat case as the pipeline runs it, one real launch on
    float32 planes), ``fir_complex`` at FIR's bench shape, and fft2d at the
    frontend tile and the pipeline's smoke grid (the fused kernel, with
    the composition's device time beside it): kernel, plain version, one
    PyTorch call and bound.  The library call takes float32 copies of
    integer inputs (``F.conv1d``/``F.conv2d`` take no integers on the
    card), with TF32 off.  Device time on the launch the runtime picks and
    on the generic instantiation, and of a ``copy_`` of the same bytes at
    the bench shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels import (build, conv2d, fir, ref, registry,
                                     runtime, widesa_mm)

    gen = torch.Generator(device="cuda").manual_seed(5)
    library = {
        "fir": lambda a, b: F.conv1d(a[None, None], b[None, None]),
        "conv2d": lambda a, b: F.conv2d(a[None, None], b[None, None]),
    }
    cases = [("fir", "main", SP_MAIN["fir"], torch.int16, 50),
             ("conv2d", "main", SP_MAIN["conv2d"], torch.int16, 50)]
    # cfloat draws float32 planes (registry.operands), one real launch
    cases += [(name, f"bench {dtype}", args,
               getattr(torch, "float32" if dtype == "cfloat" else dtype), 10)
              for name in ("fir", "conv2d")
              for dtype, args in registry.get(name).bench_cases]
    rows = {}
    for name, where, args, dtype, reps in cases:
        a, b = sp_operands(torch, gen, name, args, dtype)
        fn, plain, tiles = sp_kernel(name, args, dtype)
        af, bf = a.float(), b.float()
        out, want = fn(a, b), plain(a, b)
        err, ok = max_error(torch, out, want, dtype)
        if not ok:
            fail(f"{name}{args} {dtype}: max |err| {err}")
        # FIR's few microseconds a call: 50 calls a device time
        dev_reps = 50 if name == "fir" else 10
        row = dict(
            tiles=tiles, max_abs_err=err,
            ms=time_ms(torch, lambda: fn(a, b), reps),
            plain_ms=time_ms(torch, lambda: plain(a, b),
                             3 if where != "main" else reps, 1),
            library_ms=time_ms(torch, lambda: library[name](af, bf), reps),
            device_ms=device_ms(torch, lambda: fn(a, b), name + "_kernel",
                                dev_reps),
            library_device_ms=device_ms(
                torch, lambda: library[name](af, bf), None, dev_reps),
        )
        row["bound_ms"], row["bound_by"] = sp_bound_ms(
            name, args, a.element_size(), out.element_size(), str(dtype))
        # the card's own copy of the same bytes: the output's window of the
        # input, converted to the output's dtype (PyTorch's copy_)
        view = a[:out.shape[0]] if name == "fir" \
            else a[:out.shape[0], :out.shape[1]]
        row["copy_device_ms"] = device_ms(torch, lambda: out.copy_(view),
                                          None, dev_reps)
        copy = f", a copy_ of the same bytes {fmt_ms(row['copy_device_ms'])}"
        if name == "fir":
            by = "instantiation"
            generic = runtime.fir_config(*args, a.element_size(),
                                         compiled=build.FIR_GENERIC)
            others = {tiles.tile.taps: row["device_ms"]}
            if generic != tiles.tile:
                row["generic_device_ms"] = device_ms(
                    torch, lambda: fir.fir(a, b, tiles=generic), "fir_kernel",
                    dev_reps)
                others["generic"] = row["generic_device_ms"]
        else:
            by = "window"
            generic = runtime.conv2d_config(*args[2:], *args[:2],
                                            window=build.CONV2D_GENERIC)
            others = {tiles.tile.window: row["device_ms"]}
            if generic != tiles.tile:
                row["generic_device_ms"] = device_ms(
                    torch, lambda: conv2d.conv2d(a, b, tiles=generic),
                    "conv2d_kernel")
                others["generic"] = row["generic_device_ms"]
        rows[(name, where)] = row
        lib = f"F.{name if name == 'conv2d' else 'conv1d'}"
        per = ", ".join(f"{k} {fmt_ms(v)}" for k, v in others.items())
        print(f"time {name}{args} {str(dtype).removeprefix('torch.')} "
              f"[{where}{PLANES_NOTE if 'cfloat' in where else ''}] plan "
              f"block {tiles.plan} -> {tiles.tile}: kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, {lib} "
              f"{row['library_ms']:.4f} ms{' (float32 copies)' if not dtype.is_floating_point else ''}, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); device "
              f"time (profiler): kernel {fmt_ms(row['device_ms'])}, {lib} "
              f"{fmt_ms(row['library_device_ms'])}{copy}; kernel device "
              f"time by {by}: {per}; max |err| {err:.4g}", flush=True)
        del a, b, af, bf, out, want
        torch.cuda.empty_cache()
    rows[("fir_complex", "bench")] = fir_complex_timing(torch, gen)

    def fft_lib(x_re, x_im):
        return torch.fft.fft2(torch.complex(x_re, x_im))

    for shape in (FFT_MAIN, FFT_PIPELINE):
        fused, composition, tile = fft_kernel(shape)
        re_, im_ = (torch.randn(shape, generator=gen, device="cuda")
                    for _ in range(2))
        before = dict(widesa_mm.variants)
        composition(re_, im_)
        routes = {v: widesa_mm.variants[v] - before[v] for v in before}
        got, want = fused(re_, im_), ref.fft2d(re_, im_)
        r, c = shape
        n = r * c
        row = dict(
            tiles=tile,
            max_abs_err=max((g - w).abs().max().item()
                            for g, w in zip(got, want)),
            ms=time_ms(torch, lambda: fused(re_, im_)),
            plain_ms=time_ms(torch, lambda: ref.fft2d(re_, im_)),
            library_ms=time_ms(torch, lambda: fft_lib(re_, im_)),
            device_ms=device_ms(torch, lambda: fused(re_, im_),
                                "fft2d_kernel", 20),
            composition_device_ms=device_ms(
                torch, lambda: composition(re_, im_)),
            library_device_ms=device_ms(torch, lambda: fft_lib(re_, im_),
                                        None, 20),
        )
        # the function's least work: two float32 planes in and two out,
        # and an FFT's 5 N log2 N operations over the N = r * c points
        row["bound_ms"], row["bound_by"] = least_ms(
            4 * n * 4, 5 * n * math.log2(n), "float32")
        # the DFT form's (the kernel's design target): F_R's and F_C's
        # planes read once besides X and Z, and its 3 (r c^2 + r^2 c)
        # multiply-adds on the CUDA cores
        row["dft_bound_ms"], _ = least_ms(
            (2 * c * c + 2 * r * r + 4 * n) * 4,
            2 * 3 * (r * c * c + r * r * c), "float32")
        if shape == FFT_MAIN:
            rows[("fft2d", "main")] = row
        print(f"time fft2d{shape} float32 [fused kernel, {tile}]: "
              f"{row['ms']:.4f} ms (device {fmt_ms(row['device_ms'])}), "
              f"the composition (6 mm launches by kernel {routes} and its "
              f"elementwise kernels) device "
              f"{fmt_ms(row['composition_device_ms'])}, torch.fft.fft2 "
              f"{row['library_ms']:.4f} ms (device "
              f"{fmt_ms(row['library_device_ms'])}), plain (torch.fft.fft2) "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.7f} ms "
              f"({row['bound_by']}, FFT form) and {row['dft_bound_ms']:.5f} "
              f"ms (bytes, the DFT form); max |err| {row['max_abs_err']:.4g}",
              flush=True)
        del re_, im_, got, want
    return rows


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def serve(torch, device_name: str, slot: dict | None = None) -> tuple:
    """Phase 4 on the slot engine, or with ``slot`` (what phase 4
    returned) phase 5 on the paged engine: full-width qwen1.5-0.5b
    (module docstring).  Returns the launches and launches by kernel of
    the drain, and what the paged phase holds itself to: the weights, the
    prompts, each request's tokens and the eager decode step's host and
    device times."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.serve import make_engine

    cfg = get_config(ARCH)
    label = "paged" if slot else "serve"

    def submit(e):
        for p in prompts:
            e.submit_text(p, max_new_tokens=MAX_NEW)

    if slot:
        params, prompts = slot["params"], slot["prompts"]
        eng, step = paged_engine(torch, cfg, params, label, submit,
                                 slot["tokens"])
    else:
        eng = make_engine(cfg, kind="slot", max_slots=SLOTS,
                          max_seq=MAX_SEQ, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        params = eng.api.init(gen)
        eng.load(params)
        torch.cuda.synchronize()
        print(f"serve: {ARCH} at full width ({cfg.n_layers} layers, d "
              f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}) loaded in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, int(rng.integers(4, 17)))
                   for _ in range(REQUESTS)]
        step = None
    submit(eng)

    # the main path: counts start at 0 here and are read right after
    run = checked_drain(torch, eng, label, REQUESTS, device_name, step)
    done, launches = run["done"], run["launches"]
    drain_parity(torch, run["report"], label)

    # prefill logits through the kernels vs an explicit plain-version run
    # (the paged engine's at the prompt's bucket, read at its last token)
    if slot:
        batches = [token_batch(torch, p, eng.scheduler.bucket_for(len(p)))
                   for p in prompts]
        first_logits(torch, f"{label} (bucketed)", eng.api, params, done,
                     batches, last_index=[len(p) - 1 for p in prompts])
        captured_step(torch, eng, step, slot["step"], device_name)
        return launches, run["variants"], None
    first_logits(torch, label, eng.api, params, done,
                 [token_batch(torch, p) for p in prompts], MAX_SEQ)
    return launches, run["variants"], {
        "prompts": prompts, "params": params,
        "step": profile_decode(torch, eng),
        "tokens": {r.rid: list(r.output) for r in done}}


#: device time of the hand GEMM kernels in one 4-lane qwen decode step
#: when all of them ran on the tiled kernel (NVIDIA H100 80GB HBM3,
#: 700 W; PERF.md), printed beside the step's time by kernel
TILED_STEP_GEMM_MS = 22.82


def profile_decode(torch, eng) -> tuple:
    """One eager 4-lane decode step of the slot engine, profiled
    (``profile_call``).  Returns (host ms, device busy ms or None)."""
    cache = eng.api.init_cache(SLOTS, MAX_SEQ)
    tokens = torch.zeros((SLOTS, 1), dtype=torch.int32, device="cuda")
    wall, ms = profile_call(
        torch, f"decode step ({SLOTS} lanes, max_seq {MAX_SEQ}, eager; its "
        f"hand GEMMs took {TILED_STEP_GEMM_MS} ms when all ran tiled)",
        lambda: eng.api.decode(eng.params, cache, tokens), runs=5)
    return wall, sum(ms.values()) or None


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

#: the profiler's name of each GEMM kernel (``variants`` keys)
GEMM_KERNELS = {"skinny": "skinny_kernel", "wgmma": "gemm_tc_kernel",
                "tiled": "gemm_kernel"}
#: a device record of a GEMM that is none of the port's kernels: cuBLAS's
#: (``*gemm*``, ``nvjet*``, ``*xmma*``), under ``torch.matmul``
LIBRARY_GEMMS = re.compile(r"gemm|nvjet|xmma", re.IGNORECASE)


def device_by_kernel(prof) -> tuple[dict, int]:
    """Device time (ms) of a ``torch.profiler`` trace by GEMM kernel, of
    the library's GEMMs under ``torch.matmul`` (blockwise attention's
    products; the MLP pair's ``xla`` plan), and of everything else under
    ``other``, from the device's own records only (with CPU activity
    traced, an aten op's device time repeats that of the kernels it
    launched); and the number of kernel launches."""
    from torch.autograd import DeviceType

    us = dict.fromkeys([*GEMM_KERNELS, "torch.matmul", "other"], 0.0)
    kernels = 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CPU:
            continue
        fn = re.search(r"(\w+)[<(]", evt.key)
        name = TRACED_GEMMS.get(fn and fn.group(1)) or (
            "torch.matmul" if LIBRARY_GEMMS.search(evt.key) else "other")
        us[name] += evt.self_device_time_total
        if not evt.key.startswith(("Memcpy", "Memset")):
            kernels += evt.count
    return {k: v / 1e3 for k, v in us.items()}, kernels


def top_other(prof, n) -> list:
    """The ``n`` kernels of ``device_by_kernel``'s ``other`` with the most
    device time: (name without its namespaces, cut to 100 characters, ms,
    launches)."""
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        fn = re.search(r"(\w+)[<(]", evt.key)
        if (evt.device_type == DeviceType.CPU
                or TRACED_GEMMS.get(fn and fn.group(1))
                or LIBRARY_GEMMS.search(evt.key)):
            continue
        name = re.sub(r"void |at::native::|\(anonymous namespace\)::|"
                      r"at::|std::", "", evt.key)
        rows.append((name[:100], round(evt.self_device_time_total / 1e3, 3),
                     evt.count))
    return sorted(rows, key=lambda r: -r[1])[:n]


def prefill_phase(torch, device_name: str) -> tuple[dict, dict]:
    """Full-width qwen1.5-0.5b on the slot engine (4 slots, max_seq
    ``PREFILL_MAX_SEQ``) serving prompts of ``PREFILL_PROMPTS`` tokens, 8
    new tokens each: every prefill GEMM above 16 rows on the tensor-core
    kernel (``check_routes``), then the drain's GEMM shapes against the
    plain versions, each prompt's prefill logits against the plain
    versions, and one prefill of the longest prompt timed and traced."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.serve import make_engine

    cfg = get_config(ARCH)
    eng = make_engine(cfg, kind="slot", max_slots=SLOTS,
                      max_seq=PREFILL_MAX_SEQ, device="cuda")
    params = eng.api.init(torch.Generator(device="cuda").manual_seed(0))
    eng.load(params)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, p) for p in PREFILL_PROMPTS]
    for p in prompts:
        eng.submit_text(p, max_new_tokens=MAX_NEW)

    # the prefill path: counts start at 0 here and are read right after
    run = checked_drain(torch, eng, f"prefill (prompts of {PREFILL_PROMPTS} "
                        f"tokens, max_seq {PREFILL_MAX_SEQ})", len(prompts),
                        device_name)
    launches, variants = run["launches"], run["variants"]
    if min(variants["widesa_mm"]["wgmma"], variants["bmm"]["wgmma"]) == 0:
        fail(f"the tensor-core kernel was not launched on the prefill path: "
             f"{variants}")
    drain_parity(torch, run["report"], "prefill")
    first_logits(torch, "prefill", eng.api, params, run["done"],
                 [token_batch(torch, p) for p in prompts], PREFILL_MAX_SEQ)
    profile_prefill(torch, eng, prompts[-1])
    return launches, variants


def profile_prefill(torch, eng, prompt) -> None:
    """Host time of one prefill of ``prompt`` and the card's busy time in
    it by kernel (``profile_call``)."""
    batch = token_batch(torch, prompt)
    profile_call(torch, f"prefill of {len(prompt)} tokens",
                 lambda: eng.api.prefill(eng.params, batch, PREFILL_MAX_SEQ),
                 runs=5)


# ---------------------------------------------------------------------------
# stream
# ---------------------------------------------------------------------------

def stream_serve(torch, device_name: str, slot: dict | None = None) -> tuple:
    """Phase 7 on the slot engine, or with ``slot`` (what phase 7
    returned) phase 8 on the paged engine: full-width whisper-base serving
    streamed audio (module docstring).  Returns the launches and launches
    by kernel of the drain, and what the paged phase holds itself to: the
    weights, the audio streams and each request's tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import planned, runtime
    from repro_torch.models import encdec
    from repro_torch.models.transformer import cache_dtype_of
    from repro_torch.serve import make_engine, synth_samples

    cfg = get_config(STREAM_ARCH)
    label = "paged stream" if slot else "stream"

    def submit(e):
        for samples in streams:
            e.submit_audio_stream(samples, max_new_tokens=MAX_NEW)

    if slot:
        params, streams = slot["params"], slot["streams"]
        eng, step = paged_engine(torch, cfg, params, label, submit,
                                 slot["tokens"])
        fc = eng.frontend.cfg
    else:
        eng = make_engine(cfg, kind="slot", max_slots=SLOTS,
                          max_seq=MAX_SEQ, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        params = eng.api.init(gen)
        eng.load(params)
        torch.cuda.synchronize()
        fc = eng.frontend.cfg
        print(f"stream: {STREAM_ARCH} at full width ({cfg.n_enc_layers}+"
              f"{cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab}, "
              f"{cfg.dtype}) loaded in {time.perf_counter() - t0:.1f} s; "
              f"frontend {fc.dtype} chunks of {fc.chunk_samples} samples "
              f"({fc.rows}x{fc.cols} tile) -> {fc.frames_per_chunk} frames",
              flush=True)
        streams = [synth_samples(fc, 1 + i % 8, seed=i)
                   for i in range(REQUESTS)]
        step = None
    submit(eng)

    # the streaming path: counts start at 0 here and are read right after
    run = checked_drain(torch, eng, label, REQUESTS, device_name, step)
    done, launches, report = run["done"], run["launches"], run["report"]
    variants = run["variants"]
    if any(r.fed != len(r.chunks) for r in done):
        fail(f"{label}: chunks left unfed: "
             f"{[(r.rid, r.fed, len(r.chunks)) for r in done]}")
    stamps = {"frontend.fir": "pallas", "frontend.conv2d": "pallas",
              "frontend.fft2d": "xla", "mlp.pair": "xla"}
    for site, backend in stamps.items():
        if site not in report or set(report[site]["backends"]) != {backend}:
            fail(f"{label}: {site} did not run its {backend} plan: "
                 f"{report.get(site)}")
    chunks = sum(r.fed for r in done)
    if min(launches["fir"], launches["conv2d"]) == 0:
        fail(f"a kernel was not launched on the {label} path: {launches}")
    if launches["fir"] != chunks or launches["conv2d"] != chunks:
        fail(f"{label}: {chunks} chunks fed but fir/conv2d launched "
             f"{launches['fir']}/{launches['conv2d']} times")
    # the frontend's 5 x 4 filter on its compiled window
    if {k: v for k, v in variants["conv2d"].items() if v} != {"5x4": chunks}:
        fail(f"{label}: conv2d launches by window {variants['conv2d']}, the "
             f"frontend's 5 x 4 filter calls for {{'5x4': {chunks}}}")
    tiles = {k: (t.plan, t.tile) for k, t in runtime.last_tiles.items()
             if k in ("fir", "conv2d")}
    print(f"{label}: {chunks} audio chunks, every one fed, fir and conv2d "
          f"one launch each a chunk; plan block -> compiled tile {tiles}",
          flush=True)
    drain_parity(torch, report, label)

    # one request's features and stream-prefill logits through the
    # kernels vs an explicit run through the plain versions; its first
    # token the argmax of the prefill over its first chunk (the paged
    # engine's at the decoder prompt's bucket, read at its one token)
    rid = REQUESTS - 1
    req = {r.rid: r for r in done}[rid]
    samples, c = streams[rid], fc.frames_per_chunk
    tokens = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    cache_dtype = cache_dtype_of(cfg)

    def prefill(feats, bucket=None):
        logits, cache, _ = encdec.prefill_streaming(
            params, cfg, feats[None], tokens, MAX_SEQ, c, cache_dtype)
        if bucket is None:
            return logits
        return encdec.prefill_decoder(
            params, cfg, cache["enc_k"], cache["enc_v"], cache["enc_len"],
            torch.zeros((1, bucket), dtype=torch.int32, device="cuda"),
            bucket, cache_dtype,
            last_index=torch.zeros((1,), dtype=torch.int32,
                                   device="cuda"))[0]

    with torch.no_grad():
        feats = eng.frontend.offline_features(samples)
        logits = prefill(feats)
        first = prefill(feats[:c], eng.scheduler.bucket_for(1)
                        if slot else None)
        with planned.override(enabled=False):
            want_feats = eng.frontend.offline_features(samples)
            want = prefill(want_feats)
    if not torch.equal(feats, want_feats):
        fail(f"{label} request {rid}: frontend features differ from the "
             f"plain versions by {(feats - want_feats).abs().max().item()}")
    if logits.shape != (1, cfg.vocab) or not torch.isfinite(logits).all():
        fail(f"{label} request {rid}: bad stream-prefill logits "
             f"{logits.shape}")
    err = (logits.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if err > LOGIT_ATOL:
        fail(f"{label} request {rid}: stream-prefill logits differ by {err} "
             f"> {LOGIT_ATOL} from the plain versions")
    if req.output[0] != int(torch.argmax(first[0])):
        fail(f"{label} request {rid}: engine's first token is not the argmax "
             "of the stream prefill over its first chunk")
    print(f"{label}: request {rid} ({len(req.chunks)} chunks): features "
          f"{tuple(feats.shape)} equal the plain versions bitwise (int16 "
          f"frontend); stream-prefill logits max |diff| {err:.4f} <= "
          f"{LOGIT_ATOL} (max |logit| {scale:.3f}); first token matches",
          flush=True)
    if slot:
        return launches, variants, None
    return launches, variants, {
        "params": params, "streams": streams,
        "tokens": {r.rid: list(r.output) for r in done}}


# ---------------------------------------------------------------------------
# paged: the block-paged engine, its decode step captured in load()
# ---------------------------------------------------------------------------

#: rows a KV block of the paged phases
PAGED_BLOCK = 16
#: the wrappers of the GEMM kernels, the only ones a decode step launches
GEMM_WRAPPERS = ("widesa_mm", "bmm")
#: each GEMM kernel's launches by its function's name in a trace
TRACED_GEMMS = {"skinny_kernel": "skinny", "gemm_tc_kernel": "wgmma",
                "gemm_tc_int_kernel": "wgmma", "gemm_kernel": "tiled"}


def paged_engine(torch, cfg, params, label, submit, want):
    """The engines of a paged phase on the card (``SLOTS`` lanes, blocks
    of ``PAGED_BLOCK``), each loaded in a window of its own
    (``load_paged``).  First one with exact-length prefills
    (``SchedulerConfig(bucketed=False)``), whose drain of ``submit``'s
    requests must give ``want``, the slot engine's tokens; then one with
    bucketed prefills, returned with the launches by kernel of its
    captured step."""
    from repro_torch.serve import SchedulerConfig, make_engine

    for bucketed in (False, True):
        eng = make_engine(cfg, kind="paged", max_lanes=SLOTS,
                          max_seq=MAX_SEQ, block_size=PAGED_BLOCK,
                          device="cuda",
                          scheduler=SchedulerConfig(bucketed=bucketed))
        step = load_paged(torch, eng, params, label)
        if bucketed:
            break
        submit(eng)
        t0 = time.perf_counter()
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = {r.rid: list(r.output) for r in done}
        if got != want:
            fail(f"{label} (unbucketed) tokens {got} differ from the slot "
                 f"engine's {want}")
        tokens = sum(len(r.output) for r in done)
        print(f"{label}: the unbucketed drain's {len(done)} requests equal "
              f"the slot engine's tokens ({tokens} tokens in {dt:.3f} s = "
              f"{tokens / dt:.1f} tok/s, not traced); stats {eng.stats}",
              flush=True)
        del eng, done
        torch.cuda.empty_cache()
    return eng, step


def load_paged(torch, eng, params, label, tied: bool = True,
               target=None) -> dict:
    """``eng.load(params)`` in a window of its own: one decode capture,
    and ``check_routes`` on the window's GEMM launches (under a
    hierarchical ``target``, on its groups' sub-shapes: ``route_report``).
    Returns the launches by kernel of the captured step: half those of
    the window, where the warmup and the capture each run the step
    once."""
    from repro_torch.kernels import planned

    planned.planned_report_clear()
    reset_counts()
    eng.load(params)
    torch.cuda.synchronize()
    launches, variants = read_counts(), read_variants()
    if eng.stats["decode_compiles"] != 1:
        fail(f"{label} load: stats {eng.stats}")
    check_routes(f"{label} load",
                 route_report(planned.planned_report(), target), variants,
                 tied)
    if any(launches[k] for k in launches if k not in GEMM_WRAPPERS) or any(
            v % 2 for w in GEMM_WRAPPERS for v in variants[w].values()):
        fail(f"{label} load: launches {launches}, by kernel {variants}: not "
             f"two runs of one decode step of GEMMs")
    return {w: {k: v // 2 for k, v in variants[w].items()}
            for w in GEMM_WRAPPERS}


def gemm_counts() -> dict:
    return {w: dict.fromkeys(("skinny", "wgmma", "wgmma_cp", "tiled"), 0)
            for w in GEMM_WRAPPERS}


def trace_events(prof) -> list:
    """The events of a ``torch.profiler`` trace, from its Chrome export."""
    path = ROOT / "build" / "paged_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    return events


def gemm_record(event) -> tuple | None:
    """(kernel, wrapper, grid) of a trace event that is a GEMM kernel's
    launch (``bmm``'s have a batch in the grid's z, ``widesa_mm``'s none),
    else None."""
    name = re.search(r"(\w+)[<(]", event.get("name", ""))
    kernel = name and TRACED_GEMMS.get(name.group(1))
    if event.get("cat") != "kernel" or not kernel:
        return None
    grid = tuple(event["args"]["grid"])
    return kernel, "bmm" if grid[2] > 1 else "widesa_mm", grid


def traced_gemms(prof) -> tuple[dict, list, list]:
    """The GEMM kernels' launches in a ``torch.profiler`` trace, by
    wrapper and kernel: (those outside CUDA graph replays, [those of each
    replay, in the order of its ``cudaGraphLaunch``], [each replay's
    launches by ``gemm_record``]).  A replayed kernel's record carries
    the correlation id of its graph launch."""
    events = trace_events(prof)
    replays = {e["args"]["correlation"]: (gemm_counts(), Counter())
               for e in sorted((e for e in events
                                if e.get("name") == "cudaGraphLaunch"),
                               key=lambda e: e["ts"])}
    eager = (gemm_counts(), Counter())
    for e in events:
        rec = gemm_record(e)
        if rec is None:
            continue
        counts, grids = replays.get(e["args"]["correlation"], eager)
        counts[rec[1]][rec[0]] += 1
        grids[rec] += 1
    return (eager[0], [c for c, _ in replays.values()],
            [g for _, g in replays.values()])


def missing(got: dict, want: dict) -> int:
    """How many of ``want``'s launches a trace's records ``got`` lack;
    fails where the trace shows more than ``want`` (a launch in the wrong
    place, which no dropped record explains)."""
    short = 0
    for w in GEMM_WRAPPERS:
        # a trace names gemm_tc_kernel alone, whichever producer filled
        # its ring: its cp.async launches count as wgmma there
        want_w = dict(want[w])
        want_w["wgmma"] = want_w.get("wgmma", 0) + want_w.pop("wgmma_cp", 0)
        for k, n in want_w.items():
            if got[w][k] > n:
                fail(f"the trace shows GEMM launches {got}, more than "
                     f"{want}")
            short += n - got[w][k]
    return short


def counted_drain(torch, eng, step=None) -> dict:
    """``eng``'s drain, every count set to 0 just before and read just
    after: the finished requests, seconds, launches, launches by kernel,
    the eager ones among them (``check_routes`` holds them to the plan
    report, which a replay does not reach either) and how replays were
    counted.  With ``step`` (a paged engine: the launches by kernel of its
    captured step) the drain runs under ``torch.profiler`` (CUDA
    activity), since a replay passes no wrapper.  The trace must show one
    graph launch a decode step, and every replay the captured step's GEMM
    launches; the profiler can drop a kernel's record (the device's
    record buffer fills in a replay's burst of launches), so a replay
    may show fewer, never more, and one must show them all: one of the
    drain's, or else one more replay of the same graph (``traced_step``).
    The GEMM launches outside the replays must be the wrappers' counts,
    short only of dropped records.  The replays add ``steps`` times the
    captured step's launches to the counts; ``replay_grids`` holds the
    launches of the first whole replay by ``gemm_record``."""
    from contextlib import nullcontext

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import planned

    planned.planned_report_clear()
    reset_counts()
    with (profile(activities=[ProfilerActivity.CUDA]) if step
          else nullcontext()) as prof:
        t0 = time.perf_counter()
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    run = {"done": done, "seconds": dt, "launches": read_counts(),
           "variants": read_variants(), "eager_variants": read_variants(),
           "report": planned.planned_report(), "how": ""}
    if step is None:
        return run
    eager, replays, grids = traced_gemms(prof)
    steps = eng.stats["steps"]
    if len(replays) != steps:
        fail(f"the trace shows {len(replays)} graph launches in a drain of "
             f"{steps} decode steps")
    short = [missing(r, step) for r in replays]
    whole = f"which {short.count(0)} traced replays show whole"
    if 0 in short:
        run["replay_grids"] = grids[short.index(0)]
    else:
        # every replay of the drain lost a record: the same graph, replayed
        # once more with every lane inactive, traced until one trace shows
        # the captured step's launches whole
        _, attempts, grids = traced_step(torch, lambda: eng._decode([]),
                                         step)
        run["replay_grids"] = grids[0]
        whole = (f"which no traced replay of the drain shows whole (records "
                 f"missing {short}) and trace {attempts} of one more replay "
                 "of the same graph does")
    counted = {w: run["eager_variants"][w] for w in GEMM_WRAPPERS}
    dropped = sum(short) + missing(eager, counted)
    per_step = sum(sum(step[w].values()) for w in GEMM_WRAPPERS)
    records = steps * per_step + sum(sum(c.values()) for c in counted.values())
    prefills = "bucketed" if eng.scheduler.config.bucketed else \
        "exact-length"
    run["how"] = (f" (traced: {SLOTS} lanes, blocks of {PAGED_BLOCK}, "
                  f"{prefills} prefills; stats {eng.stats}; launches = the "
                  f"wrappers' {run['launches']} in the eager prefills and "
                  f"chunk feeds + {steps} replays, one graph launch a step "
                  f"in the trace, x the {per_step} GEMM launches of the "
                  f"captured step {step}, {whole}; the profiler dropped "
                  f"{dropped} of "
                  f"the drain's {records} GEMM kernel records)")
    for w in GEMM_WRAPPERS:
        for k, v in step[w].items():
            run["launches"][w] += steps * v
            run["variants"][w][k] += steps * v
    return run


def checked_drain(torch, eng, label, n, device_name, step=None,
                  tied: bool = True, gemms=GEMM_WRAPPERS,
                  target=None) -> dict:
    """``counted_drain`` held to what every serving drain must show: ``n``
    requests with ``MAX_NEW`` tokens each, every planned site planned
    with no fallback, each GEMM wrapper of the path (``gemms``: both, but
    for a model without batched products, mamba2's) launched, and the
    eager GEMM launches by kernel what ``check_routes`` calls for;
    printed in one line.  Under a hierarchical ``target`` every planned
    site's last plan is two-level, a site may fall back only where the
    copied planner gives no plan for any of its shapes (``hier_fallback``)
    and the launches are held on the groups' sub-shapes
    (``route_report``).  Returns the run."""
    run = counted_drain(torch, eng, step)
    done, report, launches = run["done"], run["report"], run["launches"]
    if len(done) != n or any(len(r.output) != MAX_NEW for r in done):
        fail(f"{label}: requests did not finish with their budget: "
             f"{[(r.rid, len(r.output)) for r in done]}")
    bad = {s: (st["planned"], st["fallback"], st["reasons"])
           for s, st in report.items()
           if (st["planned"] == 0 or st["fallback"] != 0)
           and not hier_fallback(s, st, target)}
    if target is not None:
        bad.update({s: st["last_plan"] for s, st in report.items()
                    if st["planned"]
                    and not st["last_plan"].startswith("[hier ")})
    if bad or not report:
        fail(f"{label}: planned sites that fell back or never planned: {bad}")
    if min(launches[w] for w in gemms) == 0:
        fail(f"{label}: a GEMM kernel of the path {gemms} was not launched "
             f"on the main path: {launches}")
    routes = check_routes(label, route_report(report, target),
                          run["eager_variants"], tied)
    tokens = sum(len(r.output) for r in done)
    print(f"{label}: {len(done)} requests / {tokens} tokens in "
          f"{run['seconds']:.3f} s = {tokens / run['seconds']:.1f} tok/s on "
          f"{device_name}{run['how']}; launches {launches}; GEMM launches by "
          f"kernel {run['variants']} ({routes} among the eager ones); "
          f"{len(report)} sites all planned: {sorted(report)}", flush=True)
    return run


def traced_step(torch, fn, step):
    """A ``torch.profiler`` trace (CUDA activity) of one call of ``fn``,
    a decode step, whose GEMM records are the captured step's launches
    ``step`` whole: the first of up to 5 traces that shows them all (the
    profiler can drop a kernel's record), with how many traces it took
    and its replays' launches by ``gemm_record`` (a trace is read once)."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, 6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
        eager, replays, grids = traced_gemms(prof)
        got = gemm_counts()
        for counts in (eager, *replays):
            for w in GEMM_WRAPPERS:
                for k, n in counts[w].items():
                    got[w][k] += n
        if missing(got, step) == 0:
            return prof, attempt, grids
    fail(f"5 traces of a decode step each lack records of the captured "
         f"step's GEMM launches {step}: the last shows {got}")


def captured_step(torch, eng, step, slot_step, device_name) -> None:
    """The captured decode step beside the same step run eagerly (the
    engine's own closure over the same buffers, every lane inactive) and
    the slot engine's eager step (``slot_step``): host time of each
    (median of 5; the replay through the engine's own path: stage the
    host tables with one copy, replay, read the greedy tokens), and in one
    traced run of each that shows the captured step's GEMM launches
    (``step``) whole (``traced_step``) the card's busy time by kernel and
    the kernel launches."""
    from repro_torch.kernels import planned

    def replay():
        eng._decode([])

    def eager():
        with torch.no_grad(), planned.override(policy=eng.policy):
            eng._decode_fn()
        torch.cuda.synchronize()

    parts = []
    for name, fn in (("replayed", replay), ("eager", eager)):
        fn()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        prof, attempts, _ = traced_step(torch, fn, step)
        wall = sorted(times)[len(times) // 2]
        ms, kernels = device_by_kernel(prof)
        busy = sum(ms.values())
        parts.append(
            f"{name} {wall:.2f} ms on the host clock (median of 5), device "
            + (f"busy {busy:.4f} ms in one traced run ({kernels} kernel "
               f"launches, the captured step's GEMMs whole in trace "
               f"{attempts}; skinny {ms['skinny']:.3f} ms, wgmma "
               f"{ms['wgmma']:.3f} ms, tiled {ms['tiled']:.3f} ms, other "
               f"kernels {ms['other']:.3f} ms), device idle "
               f"{max(0.0, 1 - busy / wall):.0%} of the step" if busy
               else "busy time not measured (no device events)"))
    slot_wall, slot_busy = slot_step
    print(f"profile: paged decode step ({SLOTS} lanes, max_seq {MAX_SEQ}; "
          f"the replay stages the tables, replays and reads the tokens): "
          f"{'; '.join(parts)}; the slot engine's eager step "
          f"{slot_wall:.2f} ms on the host clock, device busy "
          f"{fmt_ms(slot_busy)}; on {device_name} [{nvidia_smi()}]",
          flush=True)


# ---------------------------------------------------------------------------
# long prompts (blockwise attention) and offline audio (precomputed frames)
# ---------------------------------------------------------------------------

#: the long_prompt phase: full-width qwen1.5-0.5b prompts past the
#: blockwise threshold (2048), on engines of this horizon (8192 + 8 new
#: tokens, in whole blocks of ``PAGED_BLOCK``)
LONG_PROMPTS = (2049, 4096, 8192)
LONG_MAX_SEQ = 8448
#: the offline_audio phase: full-width whisper-base text requests, each
#: with its own [enc_frames, d_model] bf16 frames
OFFLINE_REQUESTS = 4
#: blockwise attention against sdpa on the card (fp32 operands): the CPU
#: test's tolerance (tests/test_torch_blockwise.py)
BLOCKWISE_ATOL, BLOCKWISE_RTOL = 2e-4, 1e-3
#: the GEMMs the two phases add, timed: (site, kind, shape, B
#: column-major, A in padded rows, flushed to fp32, operand dtype)
LONG_SHAPES = (
    ("attn.q/k/v/out, 8192-token prefill", "mm", (8192, 1024, 1024),
     False, False, False, "bfloat16"),
    ("mlp.gate/up, 8192-token prefill", "mm", (8192, 2816, 1024),
     False, False, False, "bfloat16"),
    ("mlp.down, 8192-token prefill", "mm", (8192, 1024, 2816),
     False, False, False, "bfloat16"),
    ("attn.decode_scores, max_seq 8448", "bmm", (64, 1, 8448, 64),
     True, False, True, "bfloat16"),
    ("attn.decode_values, max_seq 8448", "bmm", (64, 1, 64, 8448),
     False, False, False, "bfloat16"),
    ("attn.scores, whisper encoder", "bmm", (8, 1500, 1500, 64),
     True, False, True, "bfloat16"),
    ("attn.values, whisper encoder", "bmm", (8, 1500, 64, 1500),
     False, True, False, "bfloat16"),
)


def count_shapes(report: dict, shapes) -> dict:
    """Calls of each (kind, shape) of ``shapes`` a planned report counts,
    over every site."""
    out = dict.fromkeys(shapes, 0)
    for st in report.values():
        for key, n in st["shapes"].items():
            shape = ast.literal_eval(key)
            kind = "mm" if len(shape) == 3 else "bmm"
            if (kind, shape) in out:
                out[(kind, shape)] += n
    return out


def launch_signature(torch, gen, kind, shape, col, pad, flush,
                     dname) -> tuple:
    """The ``gemm_record`` of a launch of the GEMM wrapper at ``shape`` in
    ``dname`` on the configuration the serving path picks (B column-major
    with ``col``, A in padded rows with ``pad``, an fp32 result with
    ``flush``): its kernel, wrapper and grid as the launchers in
    ``SOURCE`` set it (skinny: N tiles x split, 1, batch; tensor-core: M
    tiles x split, N tiles, batch; tiled: M tiles, N tiles, batch).  How a drain's trace tells this
    shape's launches apart."""
    from repro_torch.kernels import runtime

    dtype = getattr(torch, dname)
    a, b = operands(torch, gen, kind, shape, dtype, col)
    if pad:
        a = padded(torch, a)
    _, tiles = kernel_call(kind, shape, dtype, a, b,
                           torch.float32 if flush else None)
    tile = tiles.tile
    (m, n), z = shape[-3:-1], (shape[0] if kind == "bmm" else 1)
    if isinstance(tile, runtime.SkinnyTile):
        kernel, grid = "skinny", (-(-n // runtime.SKINNY_BN) * tile.split,
                                  1, z)
    elif isinstance(tile, runtime.TcTile):
        kernel, grid = "wgmma", (-(-m // tile.bm) * tile.split,
                                 -(-n // tile.bn), z)
    else:
        kernel, grid = "tiled", (-(-m // tile[0]), -(-n // tile[1]), z)
    return kernel, "bmm" if z > 1 else "widesa_mm", grid


def two_engines(torch, cfg, params, label, submit, max_seq, device_name,
                timed=LONG_SHAPES, same_tokens=True, tied=True,
                gemms=GEMM_WRAPPERS, target=None) -> dict:
    """``submit``'s requests on the slot engine (``SLOTS`` slots), then on
    the paged engine (``SLOTS`` lanes, blocks of ``PAGED_BLOCK``,
    exact-length prefills, its decode step captured in ``load_paged``),
    both at ``max_seq``, each drain held by ``checked_drain`` (the paged
    one traced), and, with ``same_tokens``, the two engines' greedy tokens
    equal.  Returns the engines and their drains, the launches and
    launches by kernel summed over the two drains and each drain's own
    (``by_engine``), and the launches of each GEMM of ``timed``
    (``LONG_SHAPES``' layout): those the drains' planned reports count
    (every eager call), plus, for the paged drain's replays, ``steps``
    times those that its first whole replay shows at the shape's
    ``launch_signature`` (a shape there must be one the load window's
    report planned, and no other).  Where timed shapes share a signature
    (the same kernel and grid), the replay's launches there must be the
    sum of their launches in one captured step (half the load window's,
    which runs the step twice), and each shape takes its own; ``gemms``
    are the GEMM wrappers every drain must launch.  Both engines take
    ``target`` (a hierarchical target: ``checked_drain``)."""
    from repro_torch.kernels import planned
    from repro_torch.serve import SchedulerConfig, make_engine

    gen = torch.Generator(device="cuda").manual_seed(13)
    owners = {}
    for _, kind, shape, *layout in timed:
        sig = launch_signature(torch, gen, kind, shape, *layout)
        owners.setdefault(sig, []).append((kind, shape))
    shapes = [(kind, shape) for _, kind, shape, *_ in timed]
    out = {"launches": dict.fromkeys(wrappers(), 0), "variants": {},
           "shapes": dict.fromkeys(shapes, 0), "tokens": {},
           "by_engine": {}}
    for kind in ("slot", "paged"):
        step = None
        if kind == "slot":
            eng = make_engine(cfg, kind="slot", max_slots=SLOTS,
                              max_seq=max_seq, device="cuda", target=target)
            eng.load(params)
        else:
            eng = make_engine(cfg, kind="paged", max_lanes=SLOTS,
                              max_seq=max_seq, block_size=PAGED_BLOCK,
                              device="cuda", target=target,
                              scheduler=SchedulerConfig(bucketed=False))
            step = load_paged(torch, eng, params, f"{label} paged", tied,
                              target)
            in_step = count_shapes(planned.planned_report(), shapes)
            out["step_plans"] = route_report(planned.planned_report(),
                                             target)
        n = submit(eng)
        # the main path: counts start at 0 here and are read right after
        run = checked_drain(torch, eng, f"{label} {kind}", n, device_name,
                            step, tied, gemms, target)
        eager = count_shapes(run["report"], shapes)
        replayed = dict.fromkeys(shapes, 0)
        for sig, keys in owners.items():
            seen = run.get("replay_grids", {}).get(sig, 0)
            if seen and len(keys) > 1:
                per_step = {key: in_step[key] // 2 for key in keys}
                if sum(per_step.values()) != seen:
                    fail(f"{label} {kind}: the replays show {seen} launches "
                         f"{sig}, the launch of each of {keys}, whose "
                         f"captured step launches {per_step}")
                for key in keys:
                    replayed[key] = eng.stats["steps"] * per_step[key]
            elif seen:
                replayed[keys[0]] = eng.stats["steps"] * seen
        if step and any(bool(replayed[key]) != bool(in_step[key])
                        for key in shapes):
            fail(f"{label} {kind}: the replay shows timed GEMM launches "
                 f"{replayed} (by kernel and grid), the captured step's "
                 f"load window planned {in_step}")
        for key in shapes:
            out["shapes"][key] += eager[key] + replayed[key]
        out["by_engine"][kind] = {
            "launches": run["launches"], "variants": run["variants"],
            "shapes": {key: eager[key] + replayed[key] for key in shapes}}
        if shapes:
            print(f"{label} {kind}: launches of the timed GEMMs in the "
                  f"drain: " + ", ".join(
                      f"{k}{sh} {eager[(k, sh)]} eager + "
                      f"{replayed[(k, sh)]} replayed" for k, sh in shapes),
                  flush=True)
        for name, v in run["launches"].items():
            out["launches"][name] += v
        for name, by in run["variants"].items():
            into = out["variants"].setdefault(name, dict.fromkeys(by, 0))
            for k, v in by.items():
                into[k] += v
        out["tokens"][kind] = {r.rid: list(r.output) for r in run["done"]}
        out["steps"] = out.get("steps", {}) | {kind: step}
        out[kind] = (eng, run)
    if same_tokens and out["tokens"]["slot"] != out["tokens"]["paged"]:
        fail(f"{label}: the paged engine's tokens {out['tokens']['paged']} "
             f"differ from the slot engine's {out['tokens']['slot']}")
    return out


def token_batch(torch, prompt, rows=None) -> dict:
    """A prefill batch of one prompt on the card, zero-padded to ``rows``
    tokens (a bucket) where given."""
    import numpy as np

    tokens = np.zeros((1, rows or len(prompt)), np.int32)
    tokens[0, :len(prompt)] = prompt
    return {"tokens": torch.as_tensor(tokens, device="cuda")}


def first_logits(torch, label, api, params, done, batches, max_seq=None,
                 last_index=None, explain=None,
                 explained_by="near-tie routing flips") -> None:
    """Each request's prefill logits through the kernels against the same
    prefill with the plain versions (``planned.override(enabled=False)``),
    within ``LOGIT_ATOL``, and the engine's first token their argmax.
    ``batches`` are the requests' prefill inputs in rid order, the cache
    has ``max_seq`` rows (default: the prompt's), and ``last_index`` gives
    each bucketed prompt's last token, where its logits are read.  With
    ``explain`` (an MoE model: ``explain(rid, logits)`` gives (whether,
    and why) the miss is routing near-ties, ``routing_explained``; the
    SSM and hybrid models: bf16 rounding in the trunk, ``bf16_explained``,
    ``explained_by`` naming it) a request past ``LOGIT_ATOL`` passes only
    where that holds, and its first token must still be their argmax."""
    from repro_torch.kernels import planned

    worst = scale = 0.0
    explained = []
    by_rid = {r.rid: r for r in done}
    with torch.no_grad():
        for rid, batch in enumerate(batches):
            rows = batch["tokens"].shape[1]
            li = None if last_index is None else torch.tensor(
                [last_index[rid]], dtype=torch.int32, device="cuda")
            logits, _ = api.prefill(params, batch, max_seq or rows,
                                    last_index=li)
            with planned.override(enabled=False):
                want, _ = api.prefill(params, batch, max_seq or rows,
                                      last_index=li)
            if logits.shape != (1, api.cfg.vocab) or not torch.isfinite(
                    logits).all():
                fail(f"{label} request {rid}: bad prefill logits "
                     f"{logits.shape}")
            err = (logits.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            scale = max(scale, want.float().abs().max().item())
            if explain and err > LOGIT_ATOL:
                ok, why = explain(rid, logits)
                print(f"{label} request {rid} ({rows} rows): prefill logits "
                      f"differ by {err} > {LOGIT_ATOL} from the plain "
                      f"versions; {why}", flush=True)
                if not ok:
                    fail(f"{label} request {rid}: the miss is not explained "
                         f"by {explained_by}")
                explained.append(rid)
            elif err > LOGIT_ATOL:
                fail(f"{label} request {rid} ({rows} rows): prefill logits "
                     f"differ by {err} > {LOGIT_ATOL} from the plain "
                     "versions")
            if by_rid[rid].output[0] != int(torch.argmax(logits[0])):
                fail(f"{label} request {rid}: engine's first token is not "
                     "the argmax of its prefill logits")
    held = [rid for rid in range(len(batches)) if rid not in explained]
    print(f"{label}: prefill logits of the {len(batches)} requests match the "
          f"plain versions, max |diff| {worst:.4f} (max |logit| "
          f"{scale:.3f}), within {LOGIT_ATOL} for requests {held}"
          + (f", past it for {explained} only by {explained_by}"
             if explained else "")
          + "; first tokens are their argmax", flush=True)


def profile_call(torch, label, fn, runs=3, top=0) -> tuple[float, dict]:
    """Host time of ``fn`` (synchronized; median of ``runs`` after one
    warm run) and the card's busy time in one traced call, by kernel
    (``device_by_kernel``; with ``top``, that many of the other kernels
    by name, ``top_other``), beside the GEMM wrappers' launches by kernel
    in that call (none in a replay).  Returns (host ms, device ms by
    kernel, all 0 where the profiler recorded no device events)."""
    from torch.profiler import ProfilerActivity, profile

    def call():
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()

    call()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        call()
        walls.append((time.perf_counter() - t0) * 1e3)
    reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
    gemms = {w: read_variants()[w] for w in GEMM_WRAPPERS}
    wall = sorted(walls)[len(walls) // 2]
    ms, kernels = device_by_kernel(prof)
    busy = sum(ms.values())
    parts = ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
    print(f"profile: {label} {wall:.2f} ms on the host clock (median of "
          f"{runs}); GEMM wrapper launches by kernel {gemms}; "
          + (f"device busy {busy:.3f} ms in one traced call ({kernels} "
             f"kernel launches): {parts}; device idle "
             f"{max(0.0, 1 - busy / wall):.0%}" if busy else
             "device busy time not measured (the profiler recorded no "
             "device events)")
          + (f"; the largest other kernels (name, ms, launches): "
             f"{top_other(prof, top)}" if top and busy else ""), flush=True)
    return wall, ms


def blockwise_check(torch) -> None:
    """``blockwise_attention`` forced at S = 2048 (qwen1.5-0.5b's 16 heads
    of 64, fp32 operands) against ``sdpa`` on the hand kernels, causal and
    not, within the CPU test's fp32 tolerance."""
    from repro_torch.models import layers

    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((1, 2048, 16, 64), generator=gen, device="cuda")
               for _ in range(3))
    errs = []
    with torch.no_grad():
        for causal in (True, False):
            got = layers.blockwise_attention(q, k, v, causal=causal)
            want = layers.sdpa(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = (got - want).abs()
            errs.append(err.max().item())
            if not (err <= BLOCKWISE_ATOL
                    + BLOCKWISE_RTOL * want.abs()).all():
                fail(f"blockwise attention at S = 2048 (causal {causal}) "
                     f"differs from sdpa by {errs[-1]}")
    print(f"long: blockwise_attention forced at S = 2048 (16 heads of 64, "
          f"fp32, chunks {layers.Q_CHUNK}/{layers.K_CHUNK}) equals sdpa on "
          f"the hand kernels within atol {BLOCKWISE_ATOL} + rtol "
          f"{BLOCKWISE_RTOL}, causal and not (max |diff| "
          f"{max(errs):.3g})", flush=True)


def long_prompt(torch, device_name: str) -> dict:
    """Phase 9: full-width qwen1.5-0.5b at max_seq ``LONG_MAX_SEQ`` serving
    prompts of ``LONG_PROMPTS`` tokens (blockwise attention), 8 new tokens
    each, on the slot and the paged engine (``two_engines``); each
    prompt's prefill logits against the plain versions, blockwise against
    sdpa at S = 2048, the 8192-token prefill's host and device time by
    kernel, and the captured paged step's at max_seq 8448."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(ARCH)
    blockwise_check(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = build_model(cfg, "cuda").init(gen)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n) for n in LONG_PROMPTS]

    def submit(e):
        for p in prompts:
            e.submit_text(p, max_new_tokens=MAX_NEW)
        return len(prompts)

    out = two_engines(torch, cfg, params, "long", submit, LONG_MAX_SEQ,
                      device_name)
    slot, run = out["slot"]
    drain_parity(torch, run["report"], "long")
    batches = [token_batch(torch, p) for p in prompts]
    first_logits(torch, "long", slot.api, params, run["done"], batches)
    profile_call(torch, f"prefill of {LONG_PROMPTS[-1]} tokens (torch.matmul: "
                 "the blockwise attention's products)",
                 lambda: slot.api.prefill(params, batches[-1],
                                          LONG_PROMPTS[-1]))
    paged, _ = out["paged"]
    del slot
    torch.cuda.empty_cache()
    # every lane installed over blocks of its own up to the horizon, at
    # its last row: the gather reads each lane's whole K and V
    kv = paged.kv
    for lane in range(SLOTS):
        kv.install_lane(lane, kv.allocator.alloc(kv.blocks_per_lane),
                        LONG_MAX_SEQ - 1)
    kv.guard_decode_write()
    blocks = {b for lane in kv.lane_blocks for b in lane}
    if len(blocks) != SLOTS * kv.blocks_per_lane:
        fail(f"long: {len(blocks)} distinct blocks over {SLOTS} lanes")
    profile_call(torch, f"captured paged decode step ({SLOTS} lanes "
                 f"installed over {len(blocks)} distinct blocks of "
                 f"{PAGED_BLOCK} rows, each at row {LONG_MAX_SEQ - 1} of "
                 f"max_seq {LONG_MAX_SEQ}; the replay stages the tables, "
                 "replays and reads the tokens)", lambda: paged._decode([]),
                 runs=5)
    for lane in range(SLOTS):
        kv.release_lane(lane)
    print(f"long: on {device_name} [{nvidia_smi()}]", flush=True)
    return out


def offline_audio(torch, device_name: str) -> dict:
    """Phase 10: full-width whisper-base serving ``OFFLINE_REQUESTS`` text
    requests, each with its own [1500, 512] frames drawn from a seed and
    rounded to bf16 (``launch.serve.bf16_frames``), prefilled offline
    (encoder over the frames, cross K/V, prompt), 8 new tokens each, on
    the slot and the paged engine (``two_engines``); each request's
    prefill logits against the plain versions, and the encoder's host
    and device time over one utterance."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import bf16_frames
    from repro_torch.models import build_model, encdec

    cfg = get_config(STREAM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = build_model(cfg, "cuda").init(gen)
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, cfg.vocab, int(rng.integers(4, 17))),
             bf16_frames(rng, cfg)) for _ in range(OFFLINE_REQUESTS)]

    def submit(e):
        for prompt, frames in reqs:
            e.submit_text(prompt, max_new_tokens=MAX_NEW,
                          extra={"frames": frames})
        return len(reqs)

    out = two_engines(torch, cfg, params, "offline", submit, MAX_SEQ,
                      device_name)
    slot, run = out["slot"]
    mlp = run["report"].get("mlp.pair", {})
    if set(mlp.get("backends", {})) != {"xla"}:
        fail(f"offline: mlp.pair did not run its xla plan: {mlp}")
    drain_parity(torch, run["report"], "offline")
    batches = [{"tokens": torch.as_tensor(p[None], device="cuda"),
                "frames": f[None].cuda()} for p, f in reqs]
    first_logits(torch, "offline", slot.api, params, run["done"], batches)
    frames = batches[0]["frames"]
    profile_call(torch, f"encode of {tuple(frames.shape[1:])} frames "
                 "(torch.matmul: the MLP pair's xla plan)",
                 lambda: encdec.encode(params, cfg, frames), runs=5)
    print(f"offline: on {device_name} [{nvidia_smi()}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# hierarchical plans: two-level serving on one card
# ---------------------------------------------------------------------------

#: the hier phase: qwen1.5-0.5b's 8 requests of 4-512 tokens and
#: whisper-base's offline requests, both on both engines under
#: ``core.SERVING_HIERARCHICAL_TARGET`` (outer 1 x 2 over the facade's
#: inner target), at this horizon
HIER_PROMPTS = (4, 9, 13, 16, 64, 127, 256, 512)
HIER_MAX_SEQ = 528
#: (c): B as a group of a split hands it to the kernels, bitwise against
#: the same launch on contiguous copies: (label, M, N, K, dtype, split,
#: B column-major); qwen's column splits (the tied lm_head's embed.T,
#: gate/up, down, the projections) and whisper's row-split lm_head, at
#: decode and at a 512-token prompt; the integers and float32 at 256^3
PITCHED = tuple(
    (label, m, n, k, "bfloat16", split, col)
    for m in (4, 512)
    for label, n, k, split, col in (
        ("lm_head", 151936, 1024, "column", True),
        ("lm_head row-major", 151936, 1024, "column", False),
        ("mlp.gate/up", 2816, 1024, "column", False),
        ("mlp.down", 1024, 2816, "column", False),
        ("attn.q/k/v/out", 1024, 1024, "column", False),
        ("whisper lm_head", 51865, 512, "row", True))) + tuple(
    (f"{dtype} {split}", 256, 256, 256, dtype, split, split == "row")
    for dtype in ("int8", "int16", "int32", "float32")
    for split in ("column", "row"))
#: (d): lower_hierarchical(plan, "pallas") against the flat plan and the
#: plain version: (label, kind, builder args, dtype, B column-major, A in
#: padded rows, flushed to fp32); the reference bench's
#: CI_HIERARCHY_CASES, integer splits, qwen's full-width serving GEMMs
#: (decode over 528 rows, a 512-token prompt), whisper's row-split lm_head
#: and encoder scores, and the two stars at their bench sizes
HIER_CASES = (
    ("CI mm", "mm", (24, 128, 64), "float32", False, False, False),
    ("CI bmm", "bmm", (8, 12, 16, 12), "float32", False, False, False),
    ("int8 column", "mm", (256, 256, 256), "int8", False, False, False),
    ("int16 row", "mm", (256, 255, 256), "int16", True, False, False),
    ("attn.q/k/v/out decode", "mm", (4, 1024, 1024), "bfloat16",
     False, False, False),
    ("mlp.gate/up decode", "mm", (4, 2816, 1024), "bfloat16",
     False, False, False),
    ("mlp.down decode", "mm", (4, 1024, 2816), "bfloat16",
     False, False, False),
    ("lm_head decode", "mm", (4, 151936, 1024), "bfloat16",
     True, False, False),
    ("attn.decode_scores", "bmm", (64, 1, 528, 64), "bfloat16",
     True, False, True),
    ("attn.decode_values", "bmm", (64, 1, 64, 528), "bfloat16",
     False, False, False),
    ("attn.q/k/v/out prefill", "mm", (512, 1024, 1024), "bfloat16",
     False, False, False),
    ("mlp.gate/up prefill", "mm", (512, 2816, 1024), "bfloat16",
     False, False, False),
    ("mlp.down prefill", "mm", (512, 1024, 2816), "bfloat16",
     False, False, False),
    ("attn.scores prefill", "bmm", (16, 512, 512, 64), "bfloat16",
     True, False, True),
    ("attn.values prefill", "bmm", (16, 512, 64, 512), "bfloat16",
     False, True, False),
    ("whisper lm_head decode", "mm", (4, 51865, 512), "bfloat16",
     True, False, False),
    ("whisper encoder scores", "bmm", (8, 1500, 1500, 64), "bfloat16",
     True, False, True),
    ("jacobi2d bench", "jacobi2d", (10238, 10238), "float32",
     False, False, False),
    ("jacobi2d_9pt bench", "jacobi2d_9pt", (10236, 10236), "float32",
     False, False, False),
)


def pitched_operands(torch, gen, m, n, k, dtype, split, col):
    """Group 1 of a tp = 2 ``split`` of [m, k] @ [k, n], as
    ``lower_hierarchical`` slices it: a column split's B the right half of
    B's columns (row-major: rows n apart; column-major: rows of embed
    [n, k], whole), a row split's A the right half of A's columns (rows k
    apart) and its B the lower half of B's rows (column-major: columns k
    apart)."""
    a = draw(torch, gen, (m, k), dtype)
    b = (draw(torch, gen, (n, k), dtype).T if col
         else draw(torch, gen, (k, n), dtype))
    if split == "column":
        return a, b[:, n // 2:]
    return a[:, k // 2:], b[k // 2:]


def pitched_parity(torch) -> dict:
    """(c): each ``PITCHED`` group launch bitwise equal to the same kernel
    and configuration on contiguous copies, on the configuration the
    runtime picks (the skinny kernel at 4 rows, a tensor-core one above:
    no tiled launch), and for the 256^3 cases on the tiled kernel too;
    the bf16 ones timed beside the contiguous launch (profiler device
    time of the kernel's records: the mean of those the profiler keeps,
    so a dropped record lowers no reading).  These launches count for no
    path."""
    from repro_torch.kernels import runtime, widesa_mm

    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = {}
    for label, m, n, k, dname, split, col in PITCHED:
        dtype = getattr(torch, dname)
        a, b = pitched_operands(torch, gen, m, n, k, dtype, split, col)
        layout = runtime.b_layout(b)
        tiled = (16, 32, 8) if layout[0] else (16, 32, 32)
        tile = runtime.gemm_tile(a, b, tiled)
        if not isinstance(tile, (runtime.SkinnyTile, runtime.TcTile)):
            fail(f"pitched {label} {m}x{n}x{k}: B {layout} routes to the "
                 f"tiled kernel ({tile})")
        # contiguous copies in B's own orientation
        ac = a.contiguous()
        bc = (b.T.contiguous().T if layout[0] else b.contiguous())
        tiles = [tile] + ([tiled] if m == k == 256 else [])
        for t in tiles:
            got = widesa_mm.matmul(a, b, tiles=t)
            want = widesa_mm.matmul(ac, bc, tiles=t)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"pitched {label} {m}x{n}x{k} {dname} {describe(t)}: "
                     "differs from the launch on contiguous copies")
        shape = (m, *(b.shape[-1:] + a.shape[-1:]))
        row = {"shape": f"mm{shape}",
               "dtype": dname, "split": split, "b_layout": list(layout),
               "a_pitch": runtime.a_pitch(a), "kernel": describe(tile),
               "bitwise": True}
        if dname == "bfloat16":
            kernel = ("skinny_kernel" if isinstance(tile, runtime.SkinnyTile)
                      else "gemm_tc_kernel")
            row["ms"] = device_ms(torch, lambda: widesa_mm.matmul(
                a, b, tiles=tile), kernel)
            row["contiguous_ms"] = device_ms(torch, lambda: widesa_mm.matmul(
                ac, bc, tiles=tile), kernel)
            # the library call on the same pitched operands
            row["library_ms"] = device_ms(torch, lambda: torch.matmul(a, b))
        rows[f"{label} m{m}"] = row
        del a, b, ac, bc
    print(f"hier: B read at its pitch (and a row split's A at its pitch) is "
          f"bitwise equal to the same launch on contiguous copies for all "
          f"{len(rows)} cases: " + "; ".join(
              f"{key} {r['shape']} {r['dtype']} B{tuple(r['b_layout'])} "
              f"{r['kernel']}" + (f" {fmt_ms(r['ms'])} (contiguous "
                                  f"{fmt_ms(r['contiguous_ms'])}, library "
                                  f"{fmt_ms(r['library_ms'])})"
                                  if "ms" in r else "")
              for key, r in rows.items()), flush=True)
    return rows


def hier_recurrences(torch) -> tuple[dict, dict, dict]:
    """(d): each ``HIER_CASES`` recurrence planned under the serving
    target and lowered on the hand kernels (``lower_hierarchical(plan,
    "pallas")``), every count set to 0 just before and read just after
    (one launch a group, none tiled); then against the flat plan's hand
    kernel and the plain version (integers exact, float32 1e-3, bf16
    2^-7|ref| + 1e-3), with the device times of the three side by side
    (profiler; a dropped record reads low) and the hierarchical and flat
    calls' CUDA-event times (20 back to back: the host's launch rate
    below ~0.05 ms).
    Returns the launches and launches by kernel summed over the cases,
    and each case's row."""
    import functools

    from repro_torch.core import SERVING_HIERARCHICAL_TARGET as HT
    from repro_torch.core import best_plan, hierarchy
    from repro_torch.kernels import ref, registry, runtime

    gen = torch.Generator(device="cuda").manual_seed(22)
    launches = dict.fromkeys(wrappers(), 0)
    variants = {name: dict.fromkeys(v, 0)
                for name, v in read_variants().items()}
    rows = {}
    for label, kind, args, dname, col, pad, flush in HIER_CASES:
        dtype = getattr(torch, dname)
        spec = registry.get(kind)
        rec = spec.builder(*args, dname)
        plan, flat = best_plan(rec, HT), best_plan(rec, HT.inner)
        out_dtype = torch.float32 if flush else None
        if kind in ("mm", "bmm"):
            ops = operands(torch, gen, kind, args, dtype, col)
            if pad:
                ops = (padded(torch, ops[0]), ops[1])
            plain = functools.partial(ref.mm if kind == "mm" else ref.bmm,
                                      out_dtype=out_dtype)
        else:
            ops = tuple(draw(torch, gen, shape, dtype)
                        for shape in spec.operand_shapes(rec))
            plain = spec.ref
        fn = hierarchy.lower_hierarchical(plan, "pallas", out_dtype=out_dtype)
        flat_fn = functools.partial(runtime.execute_plan, flat,
                                    out_dtype=out_dtype)
        reset_counts()
        got = fn(*ops)
        torch.cuda.synchronize()
        counts, by_kernel = read_counts(), read_variants()
        wrapper = {"mm": "widesa_mm", "bmm": "bmm"}.get(kind, "jacobi2d")
        if counts[wrapper] != HT.groups or sum(counts.values()) != HT.groups \
                or by_kernel.get(wrapper, {}).get("tiled"):
            fail(f"hier {label}: launches {counts}, by kernel {by_kernel}: "
                 f"not one hand-kernel launch for each of {HT.groups} "
                 "groups")
        for name, n in counts.items():
            launches[name] += n
        for name, by in by_kernel.items():
            for key, n in by.items():
                variants[name][key] += n
        want, flat_out = plain(*ops), flat_fn(*ops)
        torch.cuda.synchronize()
        err, ok = max_error(torch, got, want, got.dtype)
        flat_err, flat_ok = max_error(torch, got, flat_out, got.dtype)
        if not (ok and flat_ok):
            fail(f"hier {label} {kind}{args} {dname}: max |err| {err} "
                 f"against the plain version, {flat_err} against the flat "
                 "plan")
        rows[label] = {
            "kind": kind, "shape": list(args), "dtype": dname,
            "split": plan.outer_split, "outer_bytes": plan.outer_bytes,
            "sub_shape": list(plan.sub_recurrence.extents),
            "launches": counts[wrapper],
            "by_kernel": {k: v for k, v in by_kernel[wrapper].items() if v},
            "max_abs_err": err, "flat_max_abs_diff": flat_err,
            "ms": device_ms(torch, lambda: fn(*ops)),
            "flat_ms": device_ms(torch, lambda: flat_fn(*ops)),
            "plain_ms": device_ms(torch, lambda: plain(*ops)),
            "events_ms": time_ms(torch, lambda: fn(*ops), reps=20),
            "flat_events_ms": time_ms(torch, lambda: flat_fn(*ops),
                                      reps=20),
            "library_ms": hier_library_ms(torch, gen, kind,
                                          plan.sub_recurrence.extents,
                                          dtype)}
        if kind in ("mm", "bmm"):
            rows[label]["bound_ms"], rows[label]["bound_by"] = gemm_bound(
                kind, tuple(args), dname,
                (out_dtype or runtime.out_dtype(dtype)).itemsize)
        del ops, got, want, flat_out
        torch.cuda.empty_cache()
    print("hier: lower_hierarchical(plan, 'pallas') under the serving "
          "target, one launch a group, against the plain version and the "
          "flat plan (ints exact, float32 1e-3, bf16 2^-7|ref| + 1e-3): "
          + "; ".join(
              f"{key} {r['kind']}{tuple(r['shape'])} {r['dtype']} "
              f"split={r['split']} -> {tuple(r['sub_shape'])} x "
              f"{r['launches']} {r['by_kernel']}: hier {fmt_ms(r['ms'])}, "
              f"flat {fmt_ms(r['flat_ms'])}, plain {fmt_ms(r['plain_ms'])} "
              f"(events: hier {r['events_ms']:.4f}, flat "
              f"{r['flat_events_ms']:.4f}), library at the group's "
              f"sub-shape {fmt_ms(r['library_ms'])}, bound "
              + (f"{r['bound_ms']:.3g} ms ({r['bound_by']})"
                 if "bound_ms" in r else "not computed (a stencil)")
              + f", max |err| {r['max_abs_err']:.3g}"
              for key, r in rows.items()), flush=True)
    return launches, variants, rows


def gemm_bound(kind, shape, dname, out_bytes):
    """``least_ms`` of a GEMM as the tensor cores run it: each operand
    read once and the output written once, or its products at bf16's
    rate, float32's three TF32 products, or the integers' 1 / 4 / 10 int8
    limb products (``LIMB_PRODUCTS``) at int8's."""
    z, m, n, k = (1, *shape) if kind == "mm" else shape
    in_bytes = {"bfloat16": 2, "float32": 4, "int8": 1, "int16": 2,
                "int32": 4}[dname]
    moved = z * ((m * k + k * n) * in_bytes + m * n * out_bytes)
    rate, passes = {"bfloat16": ("bfloat16", 1),
                    "float32": ("tfloat32", 3)}.get(
        dname, ("int8", LIMB_PRODUCTS.get(dname, 1)))
    return least_ms(moved, passes * 2 * z * m * n * k, rate)


def hier_library_ms(torch, gen, kind, sub, dtype):
    """Device time of one PyTorch call of a group's function at its
    sub-shape on fresh operands: ``torch.matmul`` / ``torch.bmm`` in bf16
    (to bf16, also where the group flushes at fp32) and float32,
    ``torch._int_mm`` for a 2-D int8 product; None where the card has no
    such call (int16, int32, an integer bmm) or for the stencils."""
    if kind not in ("mm", "bmm"):
        return None
    if kind == "mm":
        m, n, k = sub
        a, b = draw(torch, gen, (m, k), dtype), draw(torch, gen, (k, n), dtype)
    else:
        z, m, n, k = sub
        a = draw(torch, gen, (z, m, k), dtype)
        b = draw(torch, gen, (z, k, n), dtype)
    if dtype.is_floating_point:
        call = torch.matmul if kind == "mm" else torch.bmm
        return device_ms(torch, lambda: call(a, b))
    if dtype == torch.int8 and kind == "mm":
        return device_ms(torch, lambda: torch._int_mm(a, b))
    return None


def hier_logits(torch, label, api, params, done, batches, target) -> None:
    """(e): each request's prefill logits under ``target`` (the groups on
    the hand kernels) within ``LOGIT_ATOL`` of the flat plan's on the
    hand kernels, and the engine's first token their argmax."""
    from repro_torch.kernels import planned

    worst = 0.0
    by_rid = {r.rid: r for r in done}
    with torch.no_grad():
        for rid, batch in enumerate(batches):
            rows = batch["tokens"].shape[1]
            with planned.override(target=target):
                logits, _ = api.prefill(params, batch, rows)
            flat, _ = api.prefill(params, batch, rows)
            if logits.shape != (1, api.cfg.vocab) or not torch.isfinite(
                    logits).all():
                fail(f"{label} request {rid}: bad prefill logits "
                     f"{logits.shape}")
            err = (logits.float() - flat.float()).abs().max().item()
            worst = max(worst, err)
            if err > LOGIT_ATOL:
                fail(f"{label} request {rid} ({rows} rows): two-level "
                     f"prefill logits differ by {err} > {LOGIT_ATOL} from "
                     "the flat plan's")
            if by_rid[rid].output[0] != int(torch.argmax(logits[0])):
                fail(f"{label} request {rid}: the engine's first token is "
                     "not the argmax of its two-level prefill logits")
    print(f"{label}: two-level prefill logits of the {len(batches)} requests "
          f"within {LOGIT_ATOL} of the flat plan's on the hand kernels (max "
          f"|diff| {worst:.4f}); first tokens are their argmax", flush=True)


def hier_serve(torch, device_name, label, arch, prompts, extras,
               max_seq) -> dict:
    """(a), (b), (e): ``arch`` at full width served on the slot and the
    paged engine under the serving target (``two_engines``: tokens equal,
    every site two-level or falling back as the copied planner says, the
    groups' launches by kernel what their sub-shapes call for,
    ``decode_compiles`` 1), the first logits against the flat plan's, and
    the captured step and the longest request's prefill on the host
    clock and the card (profiler), beside a flat paged engine's step and
    the flat prefill.  Returns ``two_engines``' result."""
    from repro_torch.configs import get_config
    from repro_torch.core import SERVING_HIERARCHICAL_TARGET as HT
    from repro_torch.kernels import planned
    from repro_torch.models import build_model
    from repro_torch.serve import SchedulerConfig, make_engine

    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = build_model(cfg, "cuda").init(gen)

    def submit(e):
        for p, extra in zip(prompts, extras):
            e.submit_text(p, max_new_tokens=MAX_NEW, extra=extra)
        return len(prompts)

    out = two_engines(torch, cfg, params, label, submit, max_seq,
                      device_name, timed=(), target=HT)
    slot, run = out["slot"]
    batches = [{"tokens": torch.as_tensor(p[None], device="cuda"),
                **({"frames": x["frames"][None].cuda()} if x else {})}
               for p, x in zip(prompts, extras)]
    hier_logits(torch, label, slot.api, params, run["done"], batches, HT)
    paged, prun = out["paged"]
    step = out["steps"]["paged"]
    calls = sum(st["planned"] for site, st in prun["report"].items()
                if not site.startswith(NON_GEMM_SITES))
    flat = make_engine(cfg, kind="paged", max_lanes=SLOTS, max_seq=max_seq,
                       block_size=PAGED_BLOCK, device="cuda",
                       scheduler=SchedulerConfig(bucketed=False))
    flat_step = load_paged(torch, flat, params, f"{label} flat paged")
    per_step = sum(sum(v.values()) for v in step.values())
    load_calls = sum(sum(st["shapes"].values())
                     for st in out["step_plans"].values())
    if per_step * 2 != load_calls:
        fail(f"{label}: the captured step launches {step}, its load "
             f"window's plans call for {load_calls // 2} group launches a "
             "step")
    for name, eng in (("two-level", paged), ("flat", flat)):
        profile_call(
            torch, f"{label}: captured paged decode step, {name} plans "
            f"({SLOTS} lanes, max_seq {max_seq}; GEMM launches a step "
            f"{step if eng is paged else flat_step})",
            lambda: eng._decode([]), runs=5)
    longest = max(range(len(batches)),
                  key=lambda i: batches[i]["tokens"].shape[1])
    batch = batches[longest]
    rows = batch["tokens"].shape[1]
    for name, ctx in (("two-level", lambda: planned.override(target=HT)),
                      ("flat", planned.override)):
        def prefill():
            with ctx():
                slot.api.prefill(params, batch, rows)

        profile_call(torch, f"{label}: prefill of {rows} tokens, {name} "
                     "plans", prefill)
    print(f"{label}: {calls} planned GEMM calls in the paged drain's eager "
          f"prefills, every one two-level; on {device_name} "
          f"[{nvidia_smi()}]", flush=True)
    del slot, paged, flat
    torch.cuda.empty_cache()
    return out


def hier_phase(torch, device_name: str) -> dict:
    """Phase 10b: two-level hierarchical plans on the card (module
    docstring): (c) ``pitched_parity``, (d) ``hier_recurrences``, then
    full-width qwen1.5-0.5b (``HIER_PROMPTS``) and whisper-base's offline
    requests (``OFFLINE_REQUESTS`` text requests over [1500, 512] bf16
    frames) served on both engines under the serving target
    (``hier_serve``).  Returns each path's launches and launches by
    kernel, and the rows of (c) and (d)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import bf16_frames

    t0 = time.perf_counter()
    pitched = pitched_parity(torch)
    rec_launches, rec_variants, rec_rows = hier_recurrences(torch)
    paths = {"hier_recurrences": {"launches": rec_launches,
                                  "variants": rec_variants}}
    rng = np.random.default_rng(23)
    qwen = get_config(ARCH)
    prompts = [rng.integers(0, qwen.vocab, n) for n in HIER_PROMPTS]
    whisper = get_config(STREAM_ARCH)
    reqs = [(rng.integers(0, whisper.vocab, int(rng.integers(4, 17))),
             {"frames": bf16_frames(rng, whisper)})
            for _ in range(OFFLINE_REQUESTS)]
    for path, arch, ps, extras, max_seq in (
            ("qwen_hier", ARCH, prompts, [None] * len(prompts),
             HIER_MAX_SEQ),
            ("whisper_hier", STREAM_ARCH, [p for p, _ in reqs],
             [x for _, x in reqs], MAX_SEQ)):
        out = hier_serve(torch, device_name, path, arch, ps, extras,
                         max_seq)
        for kind, suffix in (("slot", ""), ("paged", "_paged")):
            paths[path + suffix] = out["by_engine"][kind]
        del out
        torch.cuda.empty_cache()
    print(f"hier: phase done in {time.perf_counter() - t0:.1f} s on "
          f"{device_name} [{nvidia_smi()}]", flush=True)
    return {"paths": paths, "pitched": pitched, "recurrences": rec_rows}


def sum_bound(torch, kind, a, b):
    """Per output, ``8 sqrt(K) 2^-24 sqrt(sum_k a^2 b^2)``: the fp32
    rounding of a sum of K products taken in either order
    (``recurrences.float_bound``'s term), which the plain version's own
    fp32 sum carries too (at K = 151936: up to 0.03 of N(0, 1) products
    against the float64 sum on an H100, PR 25)."""
    from repro_torch.kernels import ref

    plain = ref.mm if kind == "mm" else ref.bmm
    k = a.shape[-1]
    rms = plain(a.float() ** 2, b.float() ** 2, torch.float32).sqrt()
    return 8 * math.sqrt(k) * 2.0 ** -24 * rms.double()


#: shapes that ran on the tiled kernel until its work moved to the skinny
#: kernel (A streamed through the ring) and to gemm_tc_kernel (whisper's
#: scores dB: its B, the cotangent, in the padded rows dA's A is cast
#: into, by TMA): ``gemm_timings`` times the tiled kernel beside them, and
#: the new route must not be the slower (else the shape goes back to the
#: tiled kernel); a row with ``PAD_BOTH`` also times B in its own rows,
#: which gemm_tc_kernel's cp.async producer reads
MOVED_OFF_TILED = (("mm", (16, 5120, 25600)), ("bmm", (32, 64, 1500, 1500)))
#: a timed row's "A in padded rows" field where B's rows are padded too
PAD_BOTH = "A and B"


def gemm_timings(torch, timed=LONG_SHAPES, seed=12,
                 long_sums=False) -> dict:
    """The GEMMs of ``timed`` (``LONG_SHAPES``' layout) on the runtime's
    configuration against their plain versions, and timed (with
    ``long_sums``, a bf16 result over a K past ``runtime.TC_PROMOTE_K``
    within one rounding plus ``sum_bound``, since both sums round):
    ``torch.profiler`` device time of the hand kernel and of
    ``torch.matmul``/``torch.bmm`` (float32 with TF32 off; the weight
    GEMMs over a rotation of ``COLD_BYTES`` of B; the library's CUDA-event
    time where its profiler time reads below the bound, which only lost
    records explain), the plain version by CUDA events, and the bound
    (float32 on the tensor cores at three TF32 products a product, on the
    skinny kernel at the CUDA cores' rate)."""
    from repro_torch.kernels import ref, runtime

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}
    for site, kind, shape, col, pad, flush, dname in timed:
        dtype = getattr(torch, dname)
        out_dtype = torch.float32 if flush else None
        a, bs = rotation(torch, gen, kind, shape, col, dtype)
        if pad:
            a = padded(torch, a)
        own_rows = bs[0]
        if pad == PAD_BOTH:
            bs = [padded(torch, x) for x in bs]
        b = bs[0]
        fn, tiles = kernel_call(kind, shape, dtype, a, b, out_dtype)
        kernel = ("skinny_kernel"
                  if isinstance(tiles.tile, runtime.SkinnyTile)
                  else "gemm_tc_kernel"
                  if isinstance(tiles.tile, runtime.TcTile)
                  else "gemm_kernel")
        lib = torch.bmm if kind == "bmm" else torch.mm if flush \
            else torch.matmul

        def library(x, y, lib=lib, out_dtype=out_dtype):
            return lib(x, y) if out_dtype is None else lib(x, y, out_dtype)

        plain = ref.mm if kind == "mm" else ref.bmm
        out = fn(a, b)
        want = plain(a, b, out_dtype)
        err, ok = max_error(torch, out, want, out.dtype)
        if long_sums and out.dtype == torch.bfloat16 \
                and shape[-1] > runtime.TC_PROMOTE_K:
            ok = bool(((out.double() - want.double()).abs()
                       <= 2.0 ** -7 * want.double().abs() + 1e-3
                       + sum_bound(torch, kind, a, b)).all())
        if pad == PAD_BOTH:
            # B in its own rows: the route a caller without the padded
            # cast takes, held to the same plain result
            own, own_tiles = kernel_call(kind, shape, dtype, a, own_rows,
                                         out_dtype)
            own_err, own_ok = max_error(torch, own(a, own_rows), want,
                                        out.dtype)
            if not own_ok:
                fail(f"{site} {kind}{shape}, B in its own rows: max |err| "
                     f"{own_err}")
        del want
        if not ok:
            fail(f"{site} {kind}{shape}: max |err| {err}")
        reps = max(10, len(bs))
        row = dict(
            kernel=kernel, max_abs_err=err,
            ms=device_ms(torch, cycling(fn, a, bs), kernel, reps),
            library_device_ms=device_ms(
                torch, cycling(library, a, bs), None, reps),
            library_event_ms=time_ms(torch, cycling(library, a, bs),
                                     reps=max(20, len(bs)), warmup=2),
            plain_ms=time_ms(torch, lambda: plain(a, b, out_dtype),
                             reps=10, warmup=2))
        if dname == "float32" and kernel == "gemm_tc_kernel":
            (m, n, k), z = shape[-3:], (shape[0] if kind == "bmm" else 1)
            row["bound_ms"], row["bound_by"] = least_ms(
                z * (m * k + k * n + m * n) * 4, 3 * 2 * z * m * n * k,
                "tfloat32")
        else:
            row["bound_ms"], row["bound_by"] = bound_ms(
                kind, shape, dtype.itemsize, out.element_size(), dname)
        # the library's device time sums its records over the calls; below
        # the bound the profiler lost records, and the CUDA events stand
        lib_ms = row["library_device_ms"]
        row["library_ms"] = lib_ms if lib_ms is not None \
            and lib_ms >= row["bound_ms"] else row["library_event_ms"]
        moved = ""
        if (kind, shape) in MOVED_OFF_TILED:
            # CUDA events: milliseconds a call, far above the host's
            # launch rate
            tiled, tile = tiled_call(kind, shape, dtype, col, out_dtype)
            row["tiled_ms"] = time_ms(torch, cycling(tiled, a, bs), reps=5,
                                      warmup=1)
            moved = (f"; the tiled kernel {tuple(tile)} it left "
                     f"{fmt_ms(row['tiled_ms'])} (CUDA events)")
            if pad == PAD_BOTH:
                row["own_rows_ms"] = device_ms(
                    torch, lambda: own(a, own_rows), kernel, reps)
                moved += (f"; B in its own rows on "
                          f"{describe(own_tiles.tile, kind, shape)} "
                          f"{fmt_ms(row['own_rows_ms'])} (profiler; max "
                          f"|err| {own_err:.4g})")
            if row["ms"] is not None and row["tiled_ms"] is not None \
                    and row["ms"] > row["tiled_ms"]:
                fail(f"{site} {kind}{shape}: {kernel} {row['ms']} ms is "
                     f"slower than the tiled kernel's {row['tiled_ms']} ms")
        rows[(kind, shape)] = row
        print(f"time {kind}{shape} {dname}{'->fp32' if flush else ''} "
              f"[{site}] {describe(tiles.tile, kind, shape)}"
              f"{', B column-major' if col else ''}"
              f"{', A in padded rows' if pad is True else ''}"
              f"{', A and B in padded rows' if pad == PAD_BOTH else ''}"
              f": device (profiler; "
              f"{len(bs)} B operand(s)) {kernel} {fmt_ms(row['ms'])}, "
              f"torch.{lib.__name__} {fmt_ms(row['library_ms'])} (profiler "
              f"{fmt_ms(lib_ms)}, CUDA events "
              f"{row['library_event_ms']:.4f} ms), bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); plain "
              f"{row['plain_ms']:.4f} ms (CUDA events); max |err| {err:.4g}"
              f"{moved}", flush=True)
        del a, b, bs, out, own_rows
    return rows


# ---------------------------------------------------------------------------
# the MoE family: olmoe-1b-7b on both engines
# ---------------------------------------------------------------------------

MOE_ARCH = "olmoe-1b-7b"
#: the olmoe phase's prompts: four of 4-16 tokens and these, 8 new tokens
#: each, on engines of this horizon (512 + 8 tokens in whole blocks of
#: ``PAGED_BLOCK``)
MOE_LONG_PROMPTS = (64, 127, 256, 512)
MOE_MAX_SEQ = 528
#: the router's fp32 logits, hand kernel against the plain version on the
#: same input: the registry's float32 atol (sums of 2048 products, 3xTF32
#: above 16 rows); the first routing flip between the two whole-model
#: paths must sit within this gap of the plain path's top-k probability
#: to count as a near-tie (``routing_explained``)
ROUTER_ATOL = 1e-3
#: routing on the card against the same functions on the host on the same
#: logits: fp32 softmax weights summed in another order
ROUTE_ATOL = 1e-6
#: the GEMMs the MoE path adds, timed (``LONG_SHAPES``' layout): the fp32
#: router at a 4-lane decode step and a 512-token prompt, the expert
#: stack at decode (C = 1) and at a 512-token prompt (C = 80)
MOE_SHAPES = (
    ("moe.router, decode", "mm", (4, 64, 2048), False, False, False,
     "float32"),
    ("moe.router, 512-token prefill", "mm", (512, 64, 2048), False, False,
     False, "float32"),
    ("moe.gate/up, decode", "bmm", (64, 1, 1024, 2048), False, False,
     False, "bfloat16"),
    ("moe.down, decode", "bmm", (64, 1, 2048, 1024), False, False, False,
     "bfloat16"),
    ("moe.gate/up, 512-token prefill", "bmm", (64, 80, 1024, 2048), False,
     False, False, "bfloat16"),
    ("moe.down, 512-token prefill", "bmm", (64, 80, 2048, 1024), False,
     False, False, "bfloat16"),
)
MOE_SITES = ("moe.router", "moe.gate", "moe.up", "moe.down")


def moe_parts(torch, cfg, params) -> None:
    """The MoE block's parts on the card, each alone, on layer 0's weights
    at a 4-lane decode step's and a 512-token prompt's token count: the
    router's fp32 logits against the plain version (``ROUTER_ATOL``);
    ``route`` against the same function on the host on the same logits
    (ids equal but where two probabilities lie within ``ROUTE_ATOL``,
    weights within it); ``dispatch_indices`` and ``dispatch`` on the
    card's routing against the host's, bit for bit; each expert bmm
    against the plain version on the same operands (the bf16 bound); the
    combine against the host's on the same expert outputs, bit for bit;
    two runs of the whole block the same bits."""
    from repro_torch.kernels import planned, ref
    from repro_torch.models import layers, moe

    lp = params["layers"][0]["moe"]
    e = cfg.moe_num_experts
    gen = torch.Generator(device="cuda").manual_seed(14)
    act = layers.activation(cfg)
    parts = []
    for t in (SLOTS, MOE_LONG_PROMPTS[-1]):
        cap = moe.capacity_of(cfg, t)
        x = torch.randn((t, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            logits = planned.planned_dense(x.float(), lp["router"],
                                           site="moe.router")
            err, ok = max_error(torch, logits, ref.mm(x.float(), lp["router"]),
                                torch.float32)
            if not ok or err > ROUTER_ATOL:
                fail(f"olmoe parts T={t}: router logits differ from the "
                     f"plain version by {err}")
            w, ids, _ = moe.route(cfg, logits)
            hw, hids, hprobs = moe.route(cfg, logits.cpu())
            flips = (ids.cpu() != hids).any(-1).nonzero().flatten().tolist()
            for row in flips:
                p = hprobs[row]
                gap = (p[hids[row]].min() - p[ids[row].cpu()].min()).abs()
                if gap > ROUTE_ATOL:
                    fail(f"olmoe parts T={t}: token {row} routes to "
                         f"{ids[row].tolist()} on the card, "
                         f"{hids[row].tolist()} on the host (gap {gap})")
            werr = (w.cpu() - hw).abs().max().item() if not flips else 0.0
            if werr > ROUTE_ATOL:
                fail(f"olmoe parts T={t}: routing weights differ from the "
                     f"host's by {werr}")
            idx = moe.dispatch_indices(cfg, ids, cap)
            hidx = moe.dispatch_indices(cfg, ids.cpu(), cap)
            buf = moe.dispatch(x, idx[1], idx[3], e, cap)
            hbuf = moe.dispatch(x.cpu(), hidx[1], hidx[3], e, cap)
            if not (all(torch.equal(a.cpu(), b) for a, b in zip(idx, hidx))
                    and torch.equal(buf.cpu(), hbuf)):
                fail(f"olmoe parts T={t}: dispatch on the card differs from "
                     "the host's")
            errs = {}
            g = planned.planned_bmm(buf, lp["wg"], site="moe.gate")
            u = planned.planned_bmm(buf, lp["wu"], site="moe.up")
            h = act(g) * u
            out = planned.planned_bmm(h, lp["wd"], site="moe.down")
            for name, got, want in (("gate", g, ref.bmm(buf, lp["wg"])),
                                    ("up", u, ref.bmm(buf, lp["wu"])),
                                    ("down", out, ref.bmm(h, lp["wd"]))):
                errs[name], ok = max_error(torch, got, want, torch.bfloat16)
                if not ok:
                    fail(f"olmoe parts T={t}: moe.{name} bmm {tuple(buf.shape)}"
                         f" differs from the plain version by {errs[name]}")
            with planned.override(enabled=False):
                chain = moe.expert_ffn(cfg, lp["wg"], lp["wu"], lp["wd"], buf)
            chain_err = (out.float() - chain.float()).abs().max().item()
            flat = out.reshape(e * cap, -1)
            y = moe.combine(flat, w, idx[0], idx[1], idx[2])
            hy = moe.combine(flat.cpu(), w.cpu(), *(i.cpu() for i in idx[:3]))
            if not torch.equal(y.cpu(), hy):
                fail(f"olmoe parts T={t}: the combine on the card differs "
                     "from the host's on the same expert outputs")
            again = [moe.moe_ffn_tokens(cfg, lp, x) for _ in range(2)]
            if not torch.equal(*again):
                fail(f"olmoe parts T={t}: two runs of the MoE block differ")
        torch.cuda.synchronize()
        kept = int(idx[2].sum())
        parts.append(
            f"T={t} (C={cap}, {kept} of {t * cfg.moe_top_k} assignments "
            f"kept): router max |err| {err:.3g}, routing flips between "
            f"card and host {len(flips)}, expert bmm max |err| "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f", the chain {chain_err:.3g} against the plain chain (not "
            "held: three bf16 roundings apart)")
    print(f"olmoe parts: router within {ROUTER_ATOL} of the plain version, "
          f"routing the host's on the same logits (weights within "
          f"{ROUTE_ATOL}), dispatch and combine bit for bit the host's, "
          f"each expert bmm within the bf16 bound, the block deterministic; "
          + "; ".join(parts), flush=True)


def routing_explained(torch, api, params, batch, max_seq,
                      logits) -> tuple[bool, str]:
    """Whether the hand kernels' prefill ``logits`` of ``batch`` miss the
    plain versions' by routing near-ties only, and the evidence.  The
    prefill runs twice more with each layer's routing recorded: on the
    plain versions, and on the plain versions with the hand kernels'
    top-k ids forced at every layer (each weight renormalised from the
    plain path's own probabilities).  A flip is an expert the kernels'
    path chose and the plain path did not, with the gap by which its
    probability on the plain path misses that path's k-th.  Explained:
    every flip of the first layer that has any is a near-tie, its gap
    within ``ROUTER_ATOL`` (the layers after it route hidden states that
    the flip has already moved, and capacity couples the prompt's
    tokens, so their gaps say nothing of ties), and with the kernels'
    routing forced the plain versions' logits are within ``LOGIT_ATOL``
    of the kernels' (what is left once routing agrees is bf16
    rounding)."""
    from repro_torch.kernels import planned

    def run(enabled, forced=None):
        with RouteLog(forced) as log, torch.no_grad(), \
                planned.override(enabled=enabled):
            out, _ = api.prefill(params, batch, max_seq)
        return out, log.calls

    _, kernels = run(True)
    _, plain = run(False)
    forced, _ = run(False, [ids for ids, _ in kernels])
    flips = []
    for layer, ((ids, _), (pids, probs)) in enumerate(zip(kernels, plain)):
        kth = probs.gather(-1, pids).min(-1).values
        for tok in range(ids.shape[0]):
            for ex in sorted(set(ids[tok].tolist()) - set(pids[tok].tolist())):
                flips.append((layer, tok, ex,
                              round(float(kth[tok] - probs[tok, ex]), 7)))
    first = [f for f in flips if f[0] == flips[0][0]] if flips else []
    forced_err = (logits.float() - forced.float()).abs().max().item()
    ok = bool(first) and max(f[3] for f in first) <= ROUTER_ATOL \
        and forced_err <= LOGIT_ATOL
    return ok, (f"{len(flips)} routing flips (layer, token, expert, "
                f"probability gap to the plain path's k-th) {flips}; the "
                f"first, in layer {first[0][0] if first else None}, with "
                f"gaps within {ROUTER_ATOL}: "
                f"{bool(first) and max(f[3] for f in first) <= ROUTER_ATOL}"
                f"; with the kernels' routing forced, the plain versions' "
                f"logits differ by {forced_err:.4f} (<= {LOGIT_ATOL}: "
                f"{forced_err <= LOGIT_ATOL})")


def moe_first_tokens(torch, label, out, params, prompts) -> list:
    """The checks of an MoE model's ``two_engines`` drains (run with
    ``same_tokens`` False): each prompt's prefill logits against the plain
    versions, a miss explained only by near-tie routing
    (``routing_explained``), and the paged engine's first tokens the slot
    engine's; prints in how many requests all tokens agree.  Returns the
    prompts' prefill batches."""
    (slot, run), (paged, prun) = out["slot"], out["paged"]
    batches = [token_batch(torch, p) for p in prompts]

    def explain(rid, logits):
        return routing_explained(torch, slot.api, params, batches[rid],
                                 len(prompts[rid]), logits)

    first_logits(torch, label, slot.api, params, run["done"], batches,
                 explain=explain)
    firsts = {r.rid: r.output[0] for r in prun["done"]}
    if firsts != {r.rid: r.output[0] for r in run["done"]}:
        fail(f"{label}: the paged engine's exact-length prefills gave first "
             f"tokens {firsts}, not the slot engine's")
    same = sum(out["tokens"]["slot"][rid] == out["tokens"]["paged"][rid]
               for rid in firsts)
    print(f"{label}: the paged engine's first tokens equal the slot engine's "
          f"(stats {paged.stats}); all {MAX_NEW} tokens equal in {same} of "
          f"{len(prompts)} requests (capacity couples the {SLOTS} lanes, "
          "which the two engines fill in other orders)", flush=True)
    return batches


def moe_one_lane(torch, cfg, params, prompts, device_name,
                 label="olmoe") -> None:
    """``prompts`` on a 1-slot slot engine and a 1-lane paged engine (its
    step captured in ``load()``): the same greedy tokens, as the
    reference's ``test_paged_matches_slot_across_families`` holds its
    MoE and MLA models at 1 lane."""
    from repro_torch.serve import make_engine

    outs = []
    for kind, kw in (("slot", dict(max_slots=1)),
                     ("paged", dict(max_lanes=1, block_size=PAGED_BLOCK))):
        eng = make_engine(cfg, kind=kind, max_seq=MOE_MAX_SEQ,
                          device="cuda", **kw)
        eng.load(params)
        for p in prompts:
            eng.submit_text(p, max_new_tokens=MAX_NEW)
        outs.append({r.rid: list(r.output) for r in eng.run_until_drained()})
        if kind == "paged" and eng.stats["decode_compiles"] != 1:
            fail(f"{label} 1 lane: paged stats {eng.stats}")
        del eng
    if outs[0] != outs[1]:
        fail(f"{label} 1 lane: the paged engine's tokens {outs[1]} differ "
             f"from the slot engine's {outs[0]}")
    print(f"{label} 1 lane: {len(prompts)} requests, the paged engine's "
          f"tokens equal the slot engine's ({sum(map(len, outs[0].values()))}"
          f" tokens) on {device_name}", flush=True)


def moe_phase(torch, device_name: str) -> dict:
    """Phase 11: full-width olmoe-1b-7b (bf16, 16 layers, 64 experts of ff
    1024, top-8; random weights seeded with 0, drawn on the card) serving
    four prompts of 4-16 tokens and ``MOE_LONG_PROMPTS``, 8 new tokens
    each, on the slot and the paged engine (``two_engines``; the paged
    engine prefills MoE at exact lengths and its tokens may differ from
    the slot engine's at 4 lanes, since capacity couples the lanes), with
    every MoE site planned and no fallback; the block's parts
    (``moe_parts``), each prompt's prefill logits against the plain
    versions (a miss explained only by near-tie routing flips), the paged
    engine's first tokens the slot engine's, 1-lane slot == paged tokens,
    and the eager decode step, the captured paged step and a 512-token
    prefill profiled.  Returns each engine's launches, launches by kernel
    and ``MOE_SHAPES`` launches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(MOE_ARCH)
    t0 = time.perf_counter()
    params = build_model(cfg, "cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in iter_tensors(params))
    print(f"olmoe: {MOE_ARCH} at full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.moe_num_experts} experts of ff "
          f"{cfg.moe_d_ff}, top-{cfg.moe_top_k}, vocab {cfg.vocab}, "
          f"{cfg.dtype}; {weights / 1e9:.2f} GB of weights) drawn on the "
          f"card in {time.perf_counter() - t0:.1f} s", flush=True)
    moe_parts(torch, cfg, params)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(4, 17)))
               for _ in range(4)]
    prompts += [rng.integers(0, cfg.vocab, n) for n in MOE_LONG_PROMPTS]

    def submit(e):
        for p in prompts:
            e.submit_text(p, max_new_tokens=MAX_NEW)
        return len(prompts)

    out = two_engines(torch, cfg, params, "olmoe", submit, MOE_MAX_SEQ,
                      device_name, timed=MOE_SHAPES, same_tokens=False,
                      tied=False)
    (slot, run), (paged, prun) = out["slot"], out["paged"]
    for kind, report in (("slot", run["report"]), ("paged", prun["report"])):
        bad = {s: report.get(s) for s in MOE_SITES
               if not report.get(s, {}).get("planned")
               or report[s]["fallback"]}
        if bad:
            fail(f"olmoe {kind}: MoE sites that did not plan: {bad}")
    drains_parity(torch, run, prun, "olmoe", tied=False)
    batches = moe_first_tokens(torch, "olmoe", out, params, prompts)
    cache = slot.api.init_cache(SLOTS, MOE_MAX_SEQ)
    tokens = torch.zeros((SLOTS, 1), dtype=torch.int32, device="cuda")
    profile_call(torch, f"olmoe decode step ({SLOTS} lanes, max_seq "
                 f"{MOE_MAX_SEQ}, eager)",
                 lambda: slot.api.decode(params, cache, tokens), runs=5)
    profile_call(torch, f"olmoe captured paged decode step ({SLOTS} lanes; "
                 "the replay stages the tables, replays and reads the "
                 "tokens)", lambda: paged._decode([]), runs=5)
    profile_call(torch, f"olmoe prefill of {MOE_LONG_PROMPTS[-1]} tokens",
                 lambda: slot.api.prefill(params, batches[-1],
                                          MOE_LONG_PROMPTS[-1]), runs=5)
    by_engine = out["by_engine"]
    del slot, paged, cache, run, prun, out
    torch.cuda.empty_cache()
    moe_one_lane(torch, cfg, params, prompts[:4], device_name)
    print(f"olmoe: on {device_name} [{nvidia_smi()}]", flush=True)
    return {"olmoe": by_engine["slot"], "olmoe_paged": by_engine["paged"]}


# ---------------------------------------------------------------------------
# the SSM and hybrid families: mamba2-780m and zamba2-1.2b on both engines
# ---------------------------------------------------------------------------

#: the ssm phase's models, by path label
SSM_ARCHS = {"mamba2": "mamba2-780m", "zamba2": "zamba2-1.2b"}
#: the ssm phase's prompts: four of 4-16 tokens and these (255 inside one
#: 256-row SSD chunk, 300 padding a second, 512 two whole ones), 8 new
#: tokens each, on engines of this horizon (512 + 8 tokens in whole blocks
#: of ``PAGED_BLOCK``)
SSM_LONG_PROMPTS = (64, 255, 300, 512)
SSM_MAX_SEQ = 528
#: ``ssm_parts``' prompt and bounds.  The card's bf16 Mamba2 block against
#: the same block run on the host in fp32: bf16 rounds the block's values
#: at ~8 points (the projections, the conv output, y before and after the
#: gate, the norm, the output), each by up to half a step of an 8-bit
#: significand (2^-9), so the output's rms error sits near sqrt(8) 2^-9
#: ~ 0.55 % of its rms: held to ``SSM_OUT_RMS`` = 2^-6 (~3x), its largest
#: error to ``SSM_OUT_MAX`` = 2^-4 of the largest output; the final SSM
#: state (fp32 sums of those rounded inputs) to ``SSM_STATE_HOST`` = 2^-5
#: of its largest entry.  The chunked scan's final state against
#: ``SSM_PARTS_PROMPT`` recurrent steps on the card, both from the same
#: bf16 block (fp32 sums in another order, a conv output now and then
#: rounded to the other bf16 neighbour): ``SSM_STATE_STEPS`` = 1e-3 of its
#: largest entry.  On an H100 80GB HBM3 (700 W) the two models' blocks
#: read 0.55-0.61 %, 1.0-2.4 %, 0.61-0.64 % and 1.3e-6 to 1.6e-6.
SSM_PARTS_PROMPT = 300
#: a first-logit miss past ``LOGIT_ATOL`` (``bf16_explained``): the same
#: prompt in float32, hand kernels against the plain versions, within the
#: registry's float32 atol
FP32_LOGIT_ATOL = 1e-3
SSM_OUT_RMS = 2 ** -6
SSM_OUT_MAX = 2 ** -4
SSM_STATE_HOST = 2 ** -5
SSM_STATE_STEPS = 1e-3
#: every site each model's drains plan, as the reference plans them: the
#: slot drain (prefills and decode steps), the paged drain (its eager
#: prefills) and the paged engine's load window (its captured step).  The
#: Mamba2 blocks plan nothing; zamba2's shared block plans its projections
#: and, in a prefill, its scores and values (its out projection there is a
#: plain product, as the reference's ``@ wo``).
_HYBRID_PREFILL = {"lm_head", "attn.q", "attn.k", "attn.v", "attn.scores",
                   "attn.values", "mlp.gate", "mlp.up", "mlp.down"}
_HYBRID_DECODE = {"lm_head", "attn.q", "attn.k", "attn.v", "attn.out",
                  "mlp.gate", "mlp.up", "mlp.down"}
SSM_SITES = {
    "mamba2": ({"lm_head"}, {"lm_head"}, {"lm_head"}),
    "zamba2": (_HYBRID_PREFILL | _HYBRID_DECODE
               | {"attn.decode_scores", "attn.decode_values"},
               _HYBRID_PREFILL,
               _HYBRID_DECODE | {"attn.paged_scores", "attn.paged_values"}),
}
#: the GEMMs the two models add, timed (``LONG_SHAPES``' layout): each
#: lm_head at a 4-lane decode step, zamba2's shared block at decode (d
#: 2048, ff 8192; the q/k/v/out projections share the mlp.down launch's
#: grid) and its gate/up at a 512-token prompt
SSM_SHAPES = (
    ("lm_head, mamba2 decode", "mm", (4, 50280, 1536), False, False, False,
     "bfloat16"),
    ("lm_head, zamba2 decode", "mm", (4, 32000, 2048), False, False, False,
     "bfloat16"),
    ("attn.q/k/v/out, zamba2 decode", "mm", (4, 2048, 2048), False, False,
     False, "bfloat16"),
    ("mlp.gate/up, zamba2 decode", "mm", (4, 8192, 2048), False, False,
     False, "bfloat16"),
    ("mlp.down, zamba2 decode", "mm", (4, 2048, 8192), False, False, False,
     "bfloat16"),
    ("mlp.gate/up, zamba2 512-token prefill", "mm", (512, 8192, 2048),
     False, False, False, "bfloat16"),
)


def ssm_parts(torch, label, cfg, params) -> None:
    """One full-width Mamba2 block (the trunk's first) over a
    ``SSM_PARTS_PROMPT``-token input on the card: its output and final
    SSM state against the same block run on the host in fp32 on the same
    (bf16) weights and input, and the chunked scan's final state against
    the state ``apply_mamba_step`` reaches token by token on the card;
    the bounds at ``SSM_OUT_RMS``."""
    from repro_torch.models import ssm

    lp = params["trunk"][0]["mamba"]
    gen = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn((1, SSM_PARTS_PROMPT, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    t0 = time.perf_counter()
    with torch.no_grad():
        y, state = ssm.apply_mamba(lp, cfg, x, return_state=True)
        cache = ssm.init_mamba_cache(cfg, 1, device="cuda")
        for t in range(x.shape[1]):
            _, cache = ssm.apply_mamba_step(lp, cfg, x[:, t:t + 1], cache)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        host = {k: v.float().cpu() for k, v in lp.items()}
        hy, hstate = ssm.apply_mamba(host, cfg, x.float().cpu(),
                                     return_state=True)
    if not (torch.isfinite(y).all() and torch.isfinite(state).all()
            and torch.isfinite(cache["ssm"]).all()):
        fail(f"{label} parts: non-finite block output or state")
    diff = y.float().cpu() - hy
    out_rms = (diff.pow(2).mean().sqrt() / hy.pow(2).mean().sqrt()).item()
    out_max = (diff.abs().max() / hy.abs().max()).item()
    st_host = ((state.cpu() - hstate).abs().max()
               / hstate.abs().max()).item()
    st_steps = ((state - cache["ssm"]).abs().max()
                / state.abs().max()).item()
    for name, got, bound in (("output rms error", out_rms, SSM_OUT_RMS),
                             ("output max error", out_max, SSM_OUT_MAX),
                             ("final state against the host's", st_host,
                              SSM_STATE_HOST),
                             ("final state against the recurrent steps",
                              st_steps, SSM_STATE_STEPS)):
        if not got <= bound:
            fail(f"{label} parts: the Mamba2 block's {name} {got:.4g} "
                 f"(relative) exceeds {bound:.4g}")
    print(f"{label} parts: one Mamba2 block over {SSM_PARTS_PROMPT} tokens "
          f"({-(-SSM_PARTS_PROMPT // cfg.ssm_chunk)} chunks of "
          f"{cfg.ssm_chunk}), bf16 on the card against fp32 on the host: "
          f"output rms error {out_rms:.4g} of its rms (<= {SSM_OUT_RMS:.4g}"
          f"), max {out_max:.4g} of its max (<= {SSM_OUT_MAX:.4g}), final "
          f"SSM state {st_host:.4g} of its max (<= {SSM_STATE_HOST:.4g}); "
          f"the chunked scan's final state against {SSM_PARTS_PROMPT} "
          f"recurrent steps on the card {st_steps:.4g} of its max (<= "
          f"{SSM_STATE_STEPS:.4g}); the card's block and steps "
          f"{card_s:.2f} s", flush=True)


def bf16_explained(torch, api, params, batch, logits) -> tuple[bool, str]:
    """Whether the hand kernels' bf16 prefill ``logits`` of ``batch`` miss
    the plain versions' by the bf16 trunk's rounding only, and the
    evidence.  The Mamba2 blocks are the same torch ops on both paths; the
    paths differ only at the planned GEMMs, by rounding, and every bf16
    cast of the 38 or 48 blocks after the first such difference rounds
    its (now different) input anew, so the two bf16 paths drift apart
    layer by layer.  Explained: (1) the same
    prompt on the same weights in float32, the hand kernels (3xTF32 and
    float32 products) against the plain versions, within
    ``FP32_LOGIT_ATOL``: the kernels compute the model's function; and
    (2) the bf16 miss smaller than the bf16 plain path's own distance
    from that float32 model: the miss is within the bf16 model's rounding
    error."""
    import dataclasses

    from repro_torch.kernels import planned
    from repro_torch.models import build_model

    cfg32 = dataclasses.replace(api.cfg, dtype="float32")
    api32 = build_model(cfg32, "cuda")
    p32 = float_tree(params)
    rows = batch["tokens"].shape[1]
    with torch.no_grad():
        with planned.override(enabled=False):
            plain, _ = api.prefill(params, batch, rows)
            plain32, _ = api32.prefill(p32, batch, rows)
        kern32, _ = api32.prefill(p32, batch, rows)
    del p32
    torch.cuda.empty_cache()
    miss = (logits.float() - plain.float()).abs().max().item()
    f32 = (kern32 - plain32).abs().max().item()
    own = (plain.float() - plain32).abs().max().item()
    ok = f32 <= FP32_LOGIT_ATOL and miss < own
    return ok, (f"in float32 the hand kernels' logits differ from the plain "
                f"versions' by {f32:.3g} (<= {FP32_LOGIT_ATOL}: "
                f"{f32 <= FP32_LOGIT_ATOL}); the bf16 plain versions' "
                f"logits differ from the float32 model's by {own:.4f}, the "
                f"miss {miss:.4f} is smaller: {miss < own}")


def float_tree(tree):
    """A parameter tree (dicts and lists) with every floating tensor in
    float32."""
    if isinstance(tree, dict):
        return {k: float_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [float_tree(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


def ssm_phase(torch, device_name: str) -> dict:
    """Phase 12: full-width mamba2-780m (48 Mamba2 layers, d 1536, state
    128) and zamba2-1.2b (38 Mamba2 layers, d 2048, state 64, one shared
    attention + MLP block applied 6 times), bf16, random weights seeded
    with 0 and drawn on the card, one after the other.  For each: the
    Mamba2 block's parts (``ssm_parts``); four prompts of 4-16 tokens and
    ``SSM_LONG_PROMPTS``, 8 new tokens each, on the slot and the paged
    engine (``two_engines``: exact-length prefills, the decode step
    captured in ``load()``, the two engines' tokens equal at 4 lanes),
    every site the reference plans planned with no fallback
    (``SSM_SITES``), ``decode_compiles`` 1, ``drain_parity``, each
    prompt's prefill logits against the plain versions, and the eager
    decode step, the captured paged step and a 512-token prefill
    profiled.  Returns each engine's launches, launches by kernel and
    ``SSM_SHAPES`` launches, by path."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.hybrid import n_attn_apps

    paths = {}
    for label, arch in SSM_ARCHS.items():
        cfg = get_config(arch)
        apps = n_attn_apps(cfg)
        t0 = time.perf_counter()
        params = build_model(cfg, "cuda").init(
            torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        weights = sum(t.numel() * t.element_size()
                      for t in iter_tensors(params))
        print(f"{label}: {arch} at full width ({cfg.n_layers} Mamba2 layers, "
              f"d {cfg.d_model}, d_inner {cfg.d_inner} in {cfg.ssm_heads} "
              f"heads of {cfg.ssm_headdim}, state {cfg.ssm_state}"
              + (f", one shared attention + MLP block ({cfg.n_heads} heads "
                 f"of {cfg.hd}, ff {cfg.d_ff}) applied {apps} times"
                 if apps else "")
              + f", vocab {cfg.vocab}, {cfg.dtype}; {weights / 1e9:.2f} GB "
              f"of weights) drawn on the card in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        ssm_parts(torch, label, cfg, params)
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, cfg.vocab, int(rng.integers(4, 17)))
                   for _ in range(4)]
        prompts += [rng.integers(0, cfg.vocab, n) for n in SSM_LONG_PROMPTS]

        def submit(e, prompts=prompts):
            for p in prompts:
                e.submit_text(p, max_new_tokens=MAX_NEW)
            return len(prompts)

        out = two_engines(torch, cfg, params, label, submit, SSM_MAX_SEQ,
                          device_name, timed=SSM_SHAPES, tied=False,
                          gemms=GEMM_WRAPPERS if apps else ("widesa_mm",))
        (slot, run), (paged, prun) = out["slot"], out["paged"]
        load = paged.plan_report
        got = (set(run["report"]), set(prun["report"]), set(load))
        if got != SSM_SITES[label]:
            fail(f"{label}: planned sites (slot drain, paged drain, paged "
                 f"load) {got}, the reference plans {SSM_SITES[label]}")
        bad = {s: st for s, st in load.items()
               if not st["planned"] or st["fallback"]}
        if bad or paged.stats["decode_compiles"] != 1:
            fail(f"{label} paged: load window sites {bad}, stats "
                 f"{paged.stats}")
        drains_parity(torch, run, prun, label, tied=False)
        batches = [token_batch(torch, p) for p in prompts]

        def explain(rid, logits, api=slot.api, params=params):
            return bf16_explained(torch, api, params, batches[rid], logits)

        first_logits(torch, label, slot.api, params, run["done"], batches,
                     explain=explain,
                     explained_by="bf16 rounding in the trunk")
        print(f"{label}: the paged engine's tokens equal the slot engine's "
              f"at {SLOTS} lanes ({len(prompts)} requests of "
              f"{sorted(map(len, prompts))} tokens; stats {paged.stats}); "
              f"every site the reference plans planned with no fallback: "
              f"{sorted(got[0] | got[2])}", flush=True)
        cache = slot.api.init_cache(SLOTS, SSM_MAX_SEQ)
        tokens = torch.zeros((SLOTS, 1), dtype=torch.int32, device="cuda")
        profile_call(torch, f"{label} decode step ({SLOTS} lanes, max_seq "
                     f"{SSM_MAX_SEQ}, eager)",
                     lambda: slot.api.decode(params, cache, tokens), runs=5)
        profile_call(torch, f"{label} captured paged decode step ({SLOTS} "
                     "lanes; the replay stages the tables, replays and "
                     "reads the tokens)", lambda: paged._decode([]), runs=5,
                     top=6)
        profile_call(torch, f"{label} prefill of {SSM_LONG_PROMPTS[-1]} "
                     "tokens", lambda: slot.api.prefill(
                         params, batches[-1], SSM_LONG_PROMPTS[-1]), runs=5,
                     top=6)
        print(f"{label}: on {device_name} [{nvidia_smi()}]", flush=True)
        paths[label] = out["by_engine"]["slot"]
        paths[f"{label}_paged"] = out["by_engine"]["paged"]
        del slot, paged, cache, run, prun, out, params
        torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------
# the dense configs: llava-next-mistral-7b (vlm), stablelm-12b,
# codeqwen1.5-7b and qwen3-32b on both engines
# ---------------------------------------------------------------------------

#: the dense_configs phase's models, by path label
DENSE_ARCHS = {"llava": "llava-next-mistral-7b", "stablelm": "stablelm-12b",
               "codeqwen": "codeqwen1.5-7b", "qwen3": "qwen3-32b"}
#: its prompts, 8 new tokens each: four short (16 tokens take qwen3-32b's
#: down projection, K = 25600, onto the skinny kernel at its longest K) and
#: four long, on engines of this horizon (512 + 8 tokens in whole blocks of
#: ``PAGED_BLOCK``; llava's requests add their patch rows)
DENSE_SHORT = (4, 9, 13, 16)
DENSE_LONG = (64, 127, 256, 512)
DENSE_MAX_SEQ = 528
#: the GEMMs each model adds, timed (``LONG_SHAPES``' layout): llava's
#: patch projection over 576 patches; stablelm's attention at head dim 160
#: (a 512-token prompt's scores and values, K = 160 and N = 160, and the
#: decode step's over 528 keys); codeqwen's lm_head at decode; qwen3-32b's
#: decode GEMMs (the untied lm_head, B row-major; the out projection, whose
#: launches share the down projection's kernel and grid in a replay) and
#: the down projection of a 16-token prompt
DENSE_SHAPES = {
    "llava": (
        ("vlm.patch_proj, 576 patches", "mm", (576, 4096, 4096), False,
         False, False, "bfloat16"),),
    "stablelm": (
        ("attn.scores, 512-token prefill, head dim 160", "bmm",
         (8, 2048, 512, 160), True, False, True, "bfloat16"),
        ("attn.values, 512-token prefill, head dim 160", "bmm",
         (8, 2048, 160, 512), False, True, False, "bfloat16"),
        ("attn.decode_scores, head dim 160", "bmm", (32, 4, 528, 160), True,
         False, True, "bfloat16"),
        ("attn.decode_values, head dim 160", "bmm", (32, 4, 160, 528), False,
         False, False, "bfloat16"),),
    "codeqwen": (
        ("lm_head, codeqwen decode", "mm", (4, 92416, 4096), False, False,
         False, "bfloat16"),),
    "qwen3": (
        ("lm_head, qwen3-32b decode", "mm", (4, 151936, 5120), False, False,
         False, "bfloat16"),
        ("mlp.gate/up, qwen3-32b decode", "mm", (4, 25600, 5120), False,
         False, False, "bfloat16"),
        ("mlp.down, qwen3-32b decode", "mm", (4, 5120, 25600), False, False,
         False, "bfloat16"),
        ("attn.out, qwen3-32b decode", "mm", (4, 5120, 8192), False, False,
         False, "bfloat16"),
        ("mlp.down, qwen3-32b 16-token prefill", "mm", (16, 5120, 25600),
         False, False, False, "bfloat16"),),
}


def gib(n: int) -> str:
    return f"{n / 2**30:.2f} GiB"


def dense_phase(torch, device_name: str) -> dict:
    """Phase 12b: llava-next-mistral-7b (the vlm: mistral-7b's backbone
    with 576 patch embeddings prepended through ``vlm.patch_proj``),
    stablelm-12b (head dim 160), codeqwen1.5-7b (MHA, qkv bias, an fp8
    e4m3 KV cache) and qwen3-32b (qk_norm, untied head), each at its
    published width and depth, bf16, random weights seeded with 0 and
    drawn on the card, one after the other (each freed before the next).
    For each: ``DENSE_SHORT`` and ``DENSE_LONG`` prompts, 8 new tokens
    each (llava's each with seeded [576, 4096] bf16 patch embeddings of
    its own, so its prefills run 580-1088 rows), on the slot and the
    paged engine (``two_engines``: exact-length prefills, the decode step
    captured in ``load()``, the tokens equal), every site planned with no
    fallback (llava: ``vlm.patch_proj`` among them), ``decode_compiles``
    1, ``drain_parity``, each prompt's prefill logits within
    ``LOGIT_ATOL`` of the plain versions, the captured step and a
    512-token prefill profiled (the largest other kernels named: codeqwen's
    fp8 cache casts), the peak of allocated memory, then its
    ``DENSE_SHAPES`` timed.  Returns each engine's launches, launches by
    kernel and timed-shape launches by path, and the timed rows."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    paths, rows = {}, {}
    for label, arch in DENSE_ARCHS.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = build_model(cfg, "cuda").init(
            torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        weights = sum(t.numel() * t.element_size()
                      for t in iter_tensors(params))
        max_seq = DENSE_MAX_SEQ + cfg.vlm_patches
        print(f"{label}: {arch} at its published width and depth "
              f"({cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads "
              f"of {cfg.hd}, {cfg.n_kv_heads} KV heads, ff {cfg.d_ff}, vocab "
              f"{cfg.vocab}"
              + (", qkv bias" if cfg.qkv_bias else "")
              + (", qk_norm" if cfg.qk_norm else "")
              + (", tied head" if cfg.tie_embeddings else ", untied head")
              + (f", {cfg.vlm_patches} patch embeddings a request through "
                 f"vlm.patch_proj" if cfg.vlm_patches else "")
              + f", {cfg.dtype}, KV cache {cfg.kv_cache_dtype}; "
              f"{weights / 1e9:.2f} GB of weights) drawn on the card in "
              f"{time.perf_counter() - t0:.1f} s; engines of max_seq "
              f"{max_seq}; allocated peak so far "
              f"{gib(torch.cuda.max_memory_allocated())}", flush=True)
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, cfg.vocab, n)
                   for n in DENSE_SHORT + DENSE_LONG]
        patches = [None] * len(prompts)
        if cfg.vlm_patches:
            gen = torch.Generator(device="cuda").manual_seed(8)
            patches = [torch.randn((cfg.vlm_patches, cfg.d_model),
                                   generator=gen, device="cuda").to(
                                       torch.bfloat16) for _ in prompts]

        def submit(e, prompts=prompts, patches=patches):
            for p, pe in zip(prompts, patches):
                e.submit_text(p, max_new_tokens=MAX_NEW,
                              extra=None if pe is None
                              else {"extra_embeds": pe})
            return len(prompts)

        out = two_engines(torch, cfg, params, label, submit, max_seq,
                          device_name, timed=DENSE_SHAPES[label],
                          tied=cfg.tie_embeddings)
        (slot, run), (paged, prun) = out["slot"], out["paged"]
        if cfg.vlm_patches and not all(
                r["report"].get("vlm.patch_proj", {}).get("planned")
                for r in (run, prun)):
            fail(f"{label}: vlm.patch_proj did not plan in both drains")
        drains_parity(torch, run, prun, label, tied=cfg.tie_embeddings)
        batches = []
        for p, pe in zip(prompts, patches):
            batch = token_batch(torch, p)
            if pe is not None:
                batch["extra_embeds"] = pe[None]
            batches.append(batch)
        first_logits(torch, label, slot.api, params, run["done"], batches,
                     max_seq=max_seq)
        print(f"{label}: the paged engine's tokens equal the slot engine's "
              f"at {SLOTS} lanes ({len(prompts)} requests of "
              f"{sorted(map(len, prompts))} tokens"
              + (f" after {cfg.vlm_patches} patch rows" if cfg.vlm_patches
                 else "")
              + f"; stats {paged.stats}, decode_compiles "
              f"{paged.stats['decode_compiles']})", flush=True)
        profile_call(torch, f"{label} captured paged decode step ({SLOTS} "
                     f"lanes, max_seq {max_seq}; the replay stages the "
                     "tables, replays and reads the tokens)",
                     lambda: paged._decode([]), runs=5, top=6)
        profile_call(torch, f"{label} prefill of {DENSE_LONG[-1]} tokens"
                     + (f" after {cfg.vlm_patches} patch rows"
                        if cfg.vlm_patches else ""),
                     lambda: slot.api.prefill(params, batches[-1], max_seq),
                     runs=3, top=6)
        print(f"{label}: allocated peak {gib(torch.cuda.max_memory_allocated())}"
              f" of the card's {gib(torch.cuda.get_device_properties(0).total_memory)}"
              f" (weights {gib(weights)}, both engines' caches, the plain "
              f"versions' fp32 operands in the logit checks); on "
              f"{device_name} [{nvidia_smi()}]", flush=True)
        paths[label] = out["by_engine"]["slot"]
        paths[f"{label}_paged"] = out["by_engine"]["paged"]
        del slot, paged, run, prun, out, params, batches, patches
        torch.cuda.empty_cache()
        rows[label] = gemm_timings(torch, DENSE_SHAPES[label], seed=21)
        torch.cuda.empty_cache()
    return {"paths": paths, "rows": rows}


# ---------------------------------------------------------------------------
# MLA: deepseek-v2-236b at its published width, depth cut
# ---------------------------------------------------------------------------

DEEPSEEK_ARCH = "deepseek-v2-236b"
#: its layers on the card: the dense first layer and 7 of its 59 MoE
#: layers.  The whole model holds 235.7 B parameters (471.6 GB in bf16);
#: an MoE layer 3.97 B (7.40 GiB), so 8 layers hold 29.19 B (54.37 GiB)
#: and leave the room qwen3-32b's 61 GiB of weights left (peak 66.64 GiB)
DEEPSEEK_LAYERS = 8
#: every site the reference plans on its serving path, all planned with no
#: fallback (``moe.router`` in float32)
DEEPSEEK_SITES = ("mla.q_down", "mla.q_up", "mla.kv_down", "mla.k_rope",
                  "mla.k_up", "mla.v_up", "mla.out", "mlp.gate", "mlp.up",
                  "mlp.down", "moe.router", "moe.gate", "moe.up", "moe.down",
                  "moe.shared_gate", "moe.shared_up", "moe.shared_down",
                  "lm_head")
#: the GEMMs the MLA path adds, timed (``LONG_SHAPES``' layout): the 4-lane
#: decode step's (the rope key, the query's up projection, the output
#: projection at K = 16384, the expert stack at C = 1 over 160 experts,
#: the untied head at vocab 102400) and the latent's expansion in a
#: 512-token prompt.  The decode GEMMs that share a kernel and grid with
#: these in a replay (the dense layer's MLP, the shared experts) are timed
#: too, so that each takes its own launches
DEEPSEEK_SHAPES = (
    ("mla.k_rope, decode", "mm", (4, 64, 5120), False, False, False,
     "bfloat16"),
    ("mla.q_up, decode", "mm", (4, 24576, 1536), False, False, False,
     "bfloat16"),
    ("mla.out, decode", "mm", (4, 5120, 16384), False, False, False,
     "bfloat16"),
    ("moe.gate/up, decode (C = 1)", "bmm", (160, 1, 1536, 5120), False,
     False, False, "bfloat16"),
    ("moe.down, decode (C = 1)", "bmm", (160, 1, 5120, 1536), False, False,
     False, "bfloat16"),
    ("lm_head, decode", "mm", (4, 102400, 5120), False, False, False,
     "bfloat16"),
    ("mla.k_up/v_up, 512-token prefill", "mm", (512, 16384, 512), False,
     False, False, "bfloat16"),
    ("mlp.gate/up, decode (dense layer)", "mm", (4, 12288, 5120), False,
     False, False, "bfloat16"),
    ("mlp.down, decode (dense layer)", "mm", (4, 5120, 12288), False, False,
     False, "bfloat16"),
    ("moe.shared_gate/up, decode", "mm", (4, 3072, 5120), False, False,
     False, "bfloat16"),
    ("moe.shared_down, decode", "mm", (4, 5120, 3072), False, False, False,
     "bfloat16"),
)


def deepseek_phase(torch, device_name: str) -> dict:
    """Phase 12c: deepseek-v2-236b (MLA: kv_lora 512, q_lora 1536, 128
    heads of nope 128 + rope 64, v 128; 160 experts of ff 1536, top-6,
    2 shared; a first dense layer of ff 12288; vocab 102400) at its
    published width, cut to ``DEEPSEEK_LAYERS`` of its 60 layers, bf16,
    random weights seeded with 0 and drawn on the card: ``DENSE_SHORT``
    and ``DENSE_LONG`` prompts, 8 new tokens each, on the slot and the
    paged engine at 4 lanes (``two_engines``; exact-length prefills, the
    absorbed decode captured in ``load()``; capacity couples the lanes,
    so only the first tokens must agree) and at 1 lane (the tokens
    equal), every ``DEEPSEEK_SITES`` site planned with no fallback, no
    tiled launch (``check_routes``), ``decode_compiles`` 1,
    ``drain_parity``, the prefill logits within ``LOGIT_ATOL`` or a miss
    explained by near-tie routing, the captured step and a 512-token
    prefill profiled, the allocated peak, then ``DEEPSEEK_SHAPES`` timed.
    Returns each engine's launches, launches by kernel and timed-shape
    launches by path, and the timed rows."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(DEEPSEEK_ARCH)
    cfg = dataclasses.replace(full, n_layers=DEEPSEEK_LAYERS)
    t0 = time.perf_counter()
    params = build_model(cfg, "cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    count = {name: sum(t.numel() for t in iter_tensors(part))
             for name, part in (("dense", params["layers"][0]),
                                ("moe", params["layers"][1]),
                                ("all", params))}
    weights = sum(t.numel() * t.element_size() for t in iter_tensors(params))
    whole = (count["all"] + (full.n_layers - cfg.n_layers) * count["moe"])
    print(f"deepseek: {DEEPSEEK_ARCH} at its published width (d "
          f"{cfg.d_model}, {cfg.n_heads} heads, kv_lora {cfg.kv_lora_rank}, "
          f"q_lora {cfg.q_lora_rank}, nope {cfg.nope_head_dim} + rope "
          f"{cfg.rope_head_dim}, v {cfg.v_head_dim}; {cfg.moe_num_experts} "
          f"experts of ff {cfg.moe_d_ff}, top-{cfg.moe_top_k}, "
          f"{cfg.moe_shared_experts} shared; a dense first layer of ff "
          f"{cfg.d_ff}; vocab {cfg.vocab}; {cfg.dtype}), cut to "
          f"{cfg.n_layers} of its {full.n_layers} layers: "
          f"{count['all'] / 1e9:.2f} B parameters, {gib(weights)} of "
          f"weights drawn on the card in {time.perf_counter() - t0:.1f} s "
          f"(an MoE layer {count['moe'] / 1e9:.2f} B, the dense one "
          f"{count['dense'] / 1e9:.2f} B; the whole model "
          f"{whole / 1e9:.1f} B, {whole * 2 / 1e9:.1f} GB in bf16, which no "
          f"80 GB card holds); the latent cache "
          f"{(cfg.kv_lora_rank + cfg.rope_head_dim) * 2} bytes a token a "
          f"layer; engines of max_seq {DENSE_MAX_SEQ}; allocated peak so "
          f"far {gib(torch.cuda.max_memory_allocated())}", flush=True)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n)
               for n in DENSE_SHORT + DENSE_LONG]

    def submit(e):
        for p in prompts:
            e.submit_text(p, max_new_tokens=MAX_NEW)
        return len(prompts)

    out = two_engines(torch, cfg, params, "deepseek", submit, DENSE_MAX_SEQ,
                      device_name, timed=DEEPSEEK_SHAPES, same_tokens=False,
                      tied=False)
    (slot, run), (paged, prun) = out["slot"], out["paged"]
    for kind, r in (("slot", run), ("paged", prun)):
        bad = {s: r["report"].get(s) for s in DEEPSEEK_SITES
               if not r["report"].get(s, {}).get("planned")
               or r["report"][s]["fallback"]}
        tiled = {w: r["variants"][w]["tiled"] for w in GEMM_WRAPPERS}
        if bad or any(tiled.values()):
            fail(f"deepseek {kind}: sites that did not plan {bad}; tiled "
                 f"launches {tiled}")
    drains_parity(torch, run, prun, "deepseek", tied=False)
    print(f"deepseek: every site planned with no fallback "
          f"({len(DEEPSEEK_SITES)}: {', '.join(DEEPSEEK_SITES)}; moe.router "
          f"in float32), no tiled launch", flush=True)
    batches = moe_first_tokens(torch, "deepseek", out, params, prompts)
    profile_call(torch, f"deepseek captured paged decode step ({SLOTS} "
                 f"lanes, max_seq {DENSE_MAX_SEQ}; the replay stages the "
                 "tables, replays and reads the tokens)",
                 lambda: paged._decode([]), runs=5, top=6)
    profile_call(torch, f"deepseek prefill of {DENSE_LONG[-1]} tokens",
                 lambda: slot.api.prefill(params, batches[-1],
                                          DENSE_MAX_SEQ), runs=3, top=6)
    by_engine = out["by_engine"]
    del slot, paged, run, prun, out, batches
    torch.cuda.empty_cache()
    moe_one_lane(torch, cfg, params, prompts[:4], device_name,
                 label="deepseek")
    print(f"deepseek: allocated peak {gib(torch.cuda.max_memory_allocated())}"
          f" of the card's "
          f"{gib(torch.cuda.get_device_properties(0).total_memory)} (weights "
          f"{gib(weights)}, the engines' latent caches, the plain versions' "
          f"fp32 operands in the logit and drain checks); on {device_name} "
          f"[{nvidia_smi()}]", flush=True)
    del params
    torch.cuda.empty_cache()
    rows = gemm_timings(torch, DEEPSEEK_SHAPES, seed=23)
    torch.cuda.empty_cache()
    print(f"deepseek: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"paths": {"deepseek": by_engine["slot"],
                      "deepseek_paged": by_engine["paged"]}, "rows": rows}


# ---------------------------------------------------------------------------
# training: qwen1.5-0.5b, whisper-base, mamba2-780m, zamba2-1.2b and
# olmoe-1b-7b at full width
# ---------------------------------------------------------------------------

#: the train phases: (path, arch, text tokens, batch, the config fields the
#: phase cuts); whisper-base's frames are its published 1500 a sample.
#: grad_accum goes to 1 where the cut batch is one microbatch (whisper-base
#: 4, olmoe-1b-7b 2; mamba2-780m keeps its published 2), and olmoe-1b-7b
#: trains 10 of its 16 layers: at 14 bytes a parameter at a step's peak
#: (bf16 parameters, gradients and AdamW's new parameters; fp32 moments)
#: its 0.42 B a layer and 0.21 B besides need 90.2 GiB at 16 layers, 62.9
#: at 11 and 57.4 at 10.  The activations and temporaries add ~12 GiB
#: (a 75.18 GiB peak at 11 on an 80 GB H100), and at 11 a step ran out of
#: memory in one of two runs, with 3.73 GiB reserved but unallocated
TRAIN_PHASES = (("train", ARCH, 512, 8, {"grad_accum": 1}),
                ("whisper_train", STREAM_ARCH, 64, 4, {"grad_accum": 1}),
                ("mamba2_train", SSM_ARCHS["mamba2"], 512, 8, {}),
                ("zamba2_train", SSM_ARCHS["zamba2"], 512, 8, {}),
                ("olmoe_train", MOE_ARCH, 512, 8,
                 {"grad_accum": 1, "n_layers": 10}))
#: check (a) of the olmoe phase: two float32 copies of the full-width
#: model's gradients at this depth
MOE_PARITY_LAYERS = 2
#: the Trainer run of check (c): steps, peak rate, warmup, checkpoint
#: interval
TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP, TRAIN_CKPT_EVERY = 20, 1e-3, 2, 10
#: check (a): a float32 step's gradients on the kernels (float32 as 3xTF32)
#: against the plain versions (fp32 with TF32 off), per leaf
#: ||g_kernels - g_plain|| / ||g_plain||, and the loss's relative error
GRAD_RTOL = 1e-3
#: leaves whose exact gradient is 0 (``zero_grad_leaf``) are held to an
#: absolute bound instead: each path's gradient norm at most this share of
#: the whole gradient's norm (their rounding noise reads ~1e-10 of it on
#: whisper-base's SMOKE in float32 on the host; a typical leaf 1e-3)
ZERO_GRAD_SHARE = 1e-6
#: the backward sites each forward site of a kind adds
BWD_SITES = {"mm": ("/bwd_dx", "/bwd_dw"), "bmm": ("/bwd_da", "/bwd_db"),
             "pair": ("/bwd_up", "/bwd_dwd", "/bwd_dh", "/bwd_dwu",
                      "/bwd_dx")}
#: the backward GEMMs timed (``LONG_SHAPES``' layout: site, kind, shape, B
#: column-major, A (or, ``PAD_BOTH``, A and B) in padded rows, flushed to
#: fp32, dtype), by path: qwen's
#: weight gradients (K = the step's 4096 tokens, A = x^T copied), the tied
#: lm_head's dx (K = 151936) and dW, the scores' and values' da / db at
#: 512 tokens; whisper-base's encoder scores' da / db over 1500 frames
TRAIN_SHAPES = {
    "train": (
        ("attn.q/k/v/out/bwd_dw", "mm", (1024, 1024, 4096), False, True,
         False, "bfloat16"),
        ("mlp.gate/up/bwd_dw", "mm", (1024, 2816, 4096), False, True,
         False, "bfloat16"),
        ("mlp.down/bwd_dw", "mm", (2816, 1024, 4096), False, True, False,
         "bfloat16"),
        ("lm_head/bwd_dx", "mm", (4096, 1024, 151936), False, False, False,
         "bfloat16"),
        ("lm_head/bwd_dw", "mm", (1024, 151936, 4096), False, True, False,
         "bfloat16"),
        ("attn.scores/bwd_da, attn.values/bwd_db", "bmm", (128, 512, 64, 512),
         False, True, False, "bfloat16"),
        ("attn.scores/bwd_db", "bmm", (128, 64, 512, 512), False, True,
         False, "bfloat16"),
        ("attn.values/bwd_da", "bmm", (128, 512, 512, 64), True, False,
         False, "bfloat16"),
    ),
    "whisper_train": (
        ("attn.scores/bwd_da, encoder", "bmm", (32, 1500, 64, 1500), False,
         True, False, "bfloat16"),
        ("attn.scores/bwd_db, encoder", "bmm", (32, 64, 1500, 1500), False,
         PAD_BOTH, False, "bfloat16"),
    ),
    # mamba2 at grad_accum 2: a microbatch of 4 x 512 tokens
    "mamba2_train": (
        ("lm_head/bwd_dx, mamba2", "mm", (2048, 1536, 50280), True, False,
         False, "bfloat16"),
        ("lm_head/bwd_dw, mamba2", "mm", (1536, 50280, 2048), False, True,
         False, "bfloat16"),
    ),
    "zamba2_train": (
        ("lm_head/bwd_dx, zamba2", "mm", (4096, 2048, 32000), True, False,
         False, "bfloat16"),
        ("mlp.gate/up/bwd_dw, zamba2's shared block", "mm",
         (2048, 8192, 4096), False, True, False, "bfloat16"),
    ),
    # the expert stack over 4096 tokens: C = 640 slots an expert
    # train_4k: a microbatch of 2 x 4096 tokens
    "train_4k": (
        ("lm_head/bwd_dx, 2 x 4096 tokens", "mm", (8192, 1024, 151936),
         False, False, False, "bfloat16"),
        ("lm_head/bwd_dw, 2 x 4096 tokens", "mm", (1024, 151936, 8192),
         False, True, False, "bfloat16"),
        ("attn.q/k/v/out/bwd_dw, 2 x 4096 tokens", "mm", (1024, 1024, 8192),
         False, True, False, "bfloat16"),
    ),
    # llava: 8 x (576 patch rows + 512 text tokens) = 8704 rows, the head
    # over the 4096 text rows
    "llava_train": (
        ("attn.q/out/bwd_dw, llava", "mm", (4096, 4096, 8704), False, True,
         False, "bfloat16"),
        ("mlp.gate/up/bwd_dw, llava", "mm", (4096, 14336, 8704), False,
         True, False, "bfloat16"),
        ("mlp.down/bwd_dx, llava", "mm", (8704, 14336, 4096), True, False,
         False, "bfloat16"),
        ("lm_head/bwd_dx, llava", "mm", (4096, 4096, 32000), True, False,
         False, "bfloat16"),
    ),
    "olmoe_train": (
        ("moe.gate/up/bwd_da", "bmm", (64, 640, 2048, 1024), True, False,
         False, "bfloat16"),
        ("moe.gate/up/bwd_db", "bmm", (64, 2048, 1024, 640), False, True,
         False, "bfloat16"),
        ("moe.down/bwd_da", "bmm", (64, 640, 1024, 2048), True, False,
         False, "bfloat16"),
        ("moe.down/bwd_db", "bmm", (64, 1024, 2048, 640), False, True,
         False, "bfloat16"),
    ),
}


#: backward sites no step computes: a vlm's patch embeddings take no
#: gradient, so ``vlm.patch_proj``'s dx is never asked for (the reference's
#: custom_vjp computes it and drops it; ``tests/test_torch_train_families``)
NEVER_COMPUTED = frozenset({"vlm.patch_proj/bwd_dx"})


def site_kind(site: str, st: dict) -> str:
    """A forward site's kind: the MLP pair, mm (3 extents) or bmm."""
    if site == "mlp.pair":
        return "pair"
    return "mm" if len(st["last_shape"]) == 3 else "bmm"


def check_train_sites(label: str, report: dict) -> list:
    """Check (b): every forward site and each of its ``/bwd_*`` sites
    planned with no fallback; returns the sites."""
    bad = {s: (st["planned"], st["reasons"]) for s, st in report.items()
           if not st["planned"] or st["fallback"]}
    if bad:
        fail(f"{label}: sites that fell back or never planned: {bad}")
    lost = [f"{s}{b}" for s, st in report.items() if "/" not in s
            for b in BWD_SITES[site_kind(s, st)]
            if f"{s}{b}" not in report and f"{s}{b}" not in NEVER_COMPUTED]
    if lost:
        fail(f"{label}: backward sites missing from the report: {lost}")
    return sorted(report)


def train_launches(label: str, cfg, launches: dict, variants: dict) -> dict:
    """A train run's launches: only GEMMs, and, in every family, none on
    the tiled kernel but for an operand it keeps (a B whose rows allow no
    4-byte copy, an integer K past 8 ranks' reach: the wrappers'
    ``widesa_mm.tiled_why``, both wrappers', since the counts were set
    to 0; a training path's A
    whose rows allow none comes padded by the facade); returns the GEMM
    launches by kernel."""
    from repro_torch.kernels import runtime

    gemms = {w: {k: n for k, n in variants[w].items() if n}
             for w in GEMM_WRAPPERS}
    kept = {runtime.TILED_B_ROWS, runtime.TILED_INT_K}
    why = dict(wrappers()["widesa_mm"].tiled_why)
    if set(why) - kept:
        fail(f"{label}: tiled GEMM launches {gemms} for {why}: only an "
             f"operand of {sorted(kept)} may take the tiled kernel")
    if any(launches[k] for k in launches if k not in GEMM_WRAPPERS):
        fail(f"{label}: non-GEMM kernels launched: {launches}")
    return gemms


def zero_grad_leaf(cfg, path: str) -> bool:
    """A leaf whose exact gradient is 0: without rotary positions a key
    bias adds the same ``q . b_k`` to every score of a query's row, which
    the softmax cancels, so both paths' gradients of ``attn/bk`` and
    ``xattn/bk`` are rounding noise and their relative error says
    nothing (whisper-base: 1.2-2.3 on the first run, PR 25)."""
    return not cfg.use_rope and path.endswith("attn/bk")


def grad_parity(torch, label, cfg, shape) -> None:
    """Check (a): one float32 step at full width, the same parameters and
    batch, on the kernels and under ``configure(enabled=False)``: the loss
    and every gradient leaf within ``GRAD_RTOL`` (relative L2)."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.data import SyntheticPipeline
    from repro_torch.kernels import planned
    from repro_torch.models import build_model
    from repro_torch.train.loop import batch_tensors
    from repro_torch.train.step import value_and_grad

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    api = build_model(cfg32, "cuda")
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    batch = batch_tensors(SyntheticPipeline(cfg32, shape).batch(0), "cuda")
    before = planned.planned_report()
    t0 = time.perf_counter()
    loss_k, g_k = value_and_grad(api.loss, params, batch)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    sites = check_train_sites(f"{label} float32", planned.report_delta(
        before, planned.planned_report()))
    with planned.override(enabled=False):
        t0 = time.perf_counter()
        loss_p, g_p = value_and_grad(api.loss, params, batch)
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0
    total = max(float(torch.stack([g.double().norm() for g in
                                   tree.leaves(g_p)]).norm()), 1e-30)
    errs, zeros = [], []
    for path, a, b in zip(tree.paths(g_k), tree.leaves(g_k),
                          tree.leaves(g_p)):
        if zero_grad_leaf(cfg, path):
            zeros.append((max(float(a.double().norm()),
                              float(b.double().norm())) / total, path))
        else:
            errs.append((float((a.double() - b.double()).norm()
                               / b.double().norm().clamp(min=1e-30)), path))
    errs.sort(reverse=True)
    zeros.sort(reverse=True)
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    del g_k, g_p
    print(f"{label}: float32 step at full width on the kernels (float32 "
          f"GEMMs as 3xTF32, {len(sites)} sites planned, no fallback) "
          f"against the plain versions (fp32, TF32 off): loss "
          f"{float(loss_k):.6f} vs {float(loss_p):.6f} (relative "
          f"{loss_err:.3g}); gradient leaves' relative L2 error: largest "
          f"{errs[0][0]:.3g} ({errs[0][1]}), then {errs[1][0]:.3g} "
          f"({errs[1][1]}), median {errs[len(errs) // 2][0]:.3g} over "
          f"{len(errs)} leaves (bound {GRAD_RTOL})"
          + (f"; {len(zeros)} key-bias leaves whose exact gradient is 0 "
             f"(no rotary): largest norm {zeros[0][0]:.3g} of the whole "
             f"gradient's ({zeros[0][1]}; bound {ZERO_GRAD_SHARE})"
             if zeros else "")
          + f"; {t_k:.2f} s vs {t_p:.2f} s on the host clock", flush=True)
    if zeros and zeros[0][0] > ZERO_GRAD_SHARE:
        fail(f"{label}: key-bias gradients past {ZERO_GRAD_SHARE} of the "
             f"whole: {zeros[:5]}")
    if errs[0][0] > GRAD_RTOL or loss_err > GRAD_RTOL \
            or not math.isfinite(errs[0][0]):
        if cfg.family == "moe":
            torch.cuda.empty_cache()
            ok, why = routing_explains_grads(torch, cfg32, params, batch)
            print(f"{label}: the float32 gradients miss the plain versions' "
                  f"beyond {GRAD_RTOL}; {why}", flush=True)
            if ok:
                return
        fail(f"{label}: float32 gradients on the kernels differ from the "
             f"plain versions beyond {GRAD_RTOL}: {errs[:5]}, loss "
             f"{loss_err}")


def routing_explains_grads(torch, cfg32, params, batch) -> tuple[bool, str]:
    """Whether an MoE model's float32 gradients on the kernels miss the
    plain versions' by routing near-ties only (``routing_explained``'s
    test, for the loss and its gradients), and the evidence.  The loss and
    its gradients run again without remat (so each layer routes once, in
    order) with each layer's routing recorded: on the kernels, on the
    plain versions, and on the plain versions with the kernels' top-k ids
    forced at every layer (each weight renormalised from the plain path's
    own probabilities).  Explained: every flip of the first layer that
    has any is within ``ROUTER_ATOL`` of the plain path's k-th
    probability, and with the kernels' routing forced the loss and every
    gradient leaf are within ``GRAD_RTOL`` of the kernels'.  Runs on the
    parameters' device (``tests/test_torch_routing_check.py`` plants
    near-ties and faults on the CPU)."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.kernels import planned
    from repro_torch.models import build_model, moe
    from repro_torch.train.step import value_and_grad

    device = tree.leaves(params)[0].device.type
    api = build_model(dataclasses.replace(cfg32, remat="none"), device)
    route = moe.route

    def run(enabled, forced=None):
        seen = []

        def recording(cfg, layer_logits):
            w, ids, probs = route(cfg, layer_logits)
            if forced is not None:
                ids = forced[len(seen)]
                w = probs.gather(-1, ids)
                w = w / w.sum(dim=-1, keepdim=True)
            seen.append((ids.detach(), probs.detach()))
            return w, ids, probs

        moe.route = recording
        try:
            with planned.override(enabled=enabled):
                loss, grads = value_and_grad(api.loss, params, batch)
        finally:
            moe.route = route
        return float(loss), grads, seen

    loss_k, g_k, kernels = run(True)
    _, g_p, plain = run(False)
    del g_p
    loss_f, g_f, _ = run(False, [ids for ids, _ in kernels])
    flips = []
    for layer, ((ids, _), (pids, probs)) in enumerate(zip(kernels, plain)):
        kth = probs.gather(-1, pids).min(-1).values
        differ = (ids.sort(-1).values != pids.sort(-1).values).any(-1)
        for tok in differ.nonzero()[:, 0].tolist():
            for ex in sorted(set(ids[tok].tolist())
                             - set(pids[tok].tolist())):
                flips.append((layer, tok, ex,
                              round(float(kth[tok] - probs[tok, ex]), 9)))
    first = [f for f in flips if f[0] == flips[0][0]] if flips else []
    errs = sorted(((float((a.double() - b.double()).norm()
                          / b.double().norm().clamp(min=1e-30)), path)
                   for path, a, b in zip(tree.paths(g_k), tree.leaves(g_k),
                                         tree.leaves(g_f))), reverse=True)
    loss_err = abs(loss_k - loss_f) / abs(loss_f)
    ties = bool(first) and max(f[3] for f in first) <= ROUTER_ATOL
    ok = ties and errs[0][0] <= GRAD_RTOL and loss_err <= GRAD_RTOL
    return ok, (f"{len(flips)} routing flips over {len(kernels)} layers "
                f"(layer, token, expert, probability gap to the plain "
                f"path's k-th) {flips[:12]}; the first layer's within "
                f"{ROUTER_ATOL}: {ties}; with the kernels' routing forced "
                f"on the plain versions, the loss within {loss_err:.3g} and "
                f"the largest leaf's relative L2 error {errs[0][0]:.3g} "
                f"({errs[0][1]}; bound {GRAD_RTOL})")


def depth_cut(base, cfg, params) -> str:
    """The arithmetic of a depth cut, in words: the parameters of a layer
    and besides, counted on the trained model, at 14 bytes a parameter at
    a step's peak (bf16 parameters, gradients and AdamW's new parameters;
    the fp32 moments, updated in place) for the published depth and the
    cut one."""
    total = sum(t.numel() for t in iter_tensors(params))
    layer = sum(t.numel() for t in iter_tensors(params["layers"][-1]))
    rest = total - cfg.n_layers * layer
    return (f"{base.n_layers} layers cut to {cfg.n_layers} (TRAIN_PHASES): "
            f"{layer / 1e6:.1f} M parameters a layer and {rest / 1e6:.1f} M "
            f"besides, at 14 bytes a parameter at a step's peak (bf16 "
            f"parameters, gradients and AdamW's new parameters; fp32 "
            f"moments) {gib(14 * (rest + base.n_layers * layer))} at the "
            f"published {base.n_layers} and {gib(14 * total)} at "
            f"{cfg.n_layers}, before activations")


def profiled(torch, fn):
    """``fn()`` synchronized under ``torch.profiler`` (CUDA activity):
    (its result, device ms by kernel as ``device_by_kernel``, kernel
    launches, the 6 other kernels with the most device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ms, kernels = device_by_kernel(prof)
    return out, ms, kernels, top_other(prof, 6)


def train_timings(torch, label, trainer, params, opt, device_name) -> dict:
    """Check (d): one step's host time (median of 5), its device busy and
    idle share from ``torch.profiler`` with the forward, backward and
    optimizer traced apart (the backward's GEMMs, the remat recompute of
    each layer included, by kernel), the A operands copied to row-major
    in one step, and the tokens a second."""
    from repro_torch import tree
    from repro_torch.kernels import planned
    from repro_torch.optim import adamw_update, cosine_schedule
    from repro_torch.train.loop import batch_tensors

    tcfg = trainer.tcfg
    batch = batch_tensors(trainer.data.batch(TRAIN_STEPS), "cuda")
    walls = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = trainer.step_fn(params, opt, batch,
                                               TRAIN_STEPS + i)
        float(metrics["loss"])
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = sorted(walls[1:])[2]
    copies = dict(planned.a_copies)
    live = tree.tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, fwd, n_fwd, _ = profiled(
            torch, lambda: trainer.api.loss(live, batch))
        grads, bwd, n_bwd, top = profiled(
            torch, lambda: torch.autograd.grad(loss, tree.leaves(live)))
    _, upd, n_upd, _ = profiled(torch, lambda: adamw_update(
        tree.unflatten(params, list(grads)), opt, params,
        lr=cosine_schedule(TRAIN_STEPS, base_lr=tcfg.base_lr,
                           warmup=tcfg.warmup, total=tcfg.total_steps,
                           device="cuda"),
        weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm))
    copied = {k: planned.a_copies[k] - copies[k] for k in copies}
    busy = {part: sum(ms.values()) for part, ms in
            (("forward", fwd), ("backward", bwd), ("adamw", upd))}
    total = sum(busy.values())
    tokens = trainer.shape.seq_len * trainer.shape.global_batch
    gemm = {k: round(v, 3) for k, v in bwd.items()
            if k in GEMM_KERNELS or k == "torch.matmul"}
    print(f"{label}: one step {wall:.2f} ms on the host clock (median of 5 "
          f"after a warm step), {tokens / wall * 1e3:.0f} tokens/s; device "
          f"busy {total:.2f} ms in one traced step (forward "
          f"{busy['forward']:.2f} ms, {n_fwd} kernels; backward "
          f"{busy['backward']:.2f} ms, {n_bwd} kernels, the remat "
          f"recompute included; AdamW {busy['adamw']:.2f} ms, {n_upd} "
          f"kernels), device idle {max(0.0, 1 - total / wall):.0%}; the "
          f"backward's GEMMs by kernel (ms): {gemm}, other kernels "
          f"{bwd['other']:.2f} ms, the largest (name, ms, launches): "
          f"{top}; the forward's by kernel (ms): "
          f"{ {k: round(v, 3) for k, v in fwd.items()} }; A operands "
          f"copied to row-major in one step: {copied['calls']} copies, "
          f"{copied['bytes'] / 2**20:.1f} MiB; on {device_name} "
          f"[{nvidia_smi()}]", flush=True)
    return {"host_ms": wall, "tokens_per_s": tokens / wall * 1e3,
            "device_ms": busy, "backward_gemm_ms": gemm,
            "a_copies": copied}


def train_phase(torch, device_name: str, label: str, arch: str, seq: int,
                batch: int, cuts: dict) -> dict:
    """Phases 13, 14 and 14b: ``arch`` trained at its published width,
    bf16, ``remat="full"``, at a cut shape with the config fields ``cuts``
    changed, each cut printed (a depth cut with ``depth_cut``, and the
    run's allocated peak held to the card's memory): check (a)
    (``grad_parity``; an MoE model at ``MOE_PARITY_LAYERS`` layers), then
    the ``Trainer`` over ``TRAIN_STEPS`` steps from seeded weights with
    every count set to 0 just before and read just after (b: every
    forward and ``/bwd_*`` site planned, no fallback; the GEMM launches by
    kernel; c: every loss finite, the last 5 steps' mean below the first
    5's), check (d) (``train_timings``), then the rest of (c): with the
    first run's parameters copied to the host and freed, a fresh
    ``Trainer`` resuming at step ``TRAIN_STEPS`` with the saved parameters
    bit for bit; then the backward GEMMs of ``TRAIN_SHAPES`` timed and the
    peak of allocated memory.  Returns the path's launches, launches by
    kernel, timed rows and the launches a step of each timed shape."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch import tree
    from repro_torch.ckpt import latest_step
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES, ShapeSpec
    from repro_torch.kernels import planned
    from repro_torch.train import TrainConfig, Trainer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = get_config(arch)
    cfg = dataclasses.replace(base, **{k: v for k, v in cuts.items()
                                       if k != "n_layers"})
    shape = ShapeSpec("card", "train", seq, batch)
    if cfg.remat != "full" or cfg.dtype != "bfloat16":
        fail(f"{label}: {arch} is not bf16 with remat='full'")
    full = SHAPES["train_4k"]
    said = [f"the batch cut to {batch} utterances of {cfg.enc_frames} "
            f"frames and {seq} text tokens" if cfg.family == "encdec" else
            f"{full.name}'s {full.seq_len} tokens x {full.global_batch} "
            f"cut to {seq} x {batch}"]
    if cfg.grad_accum != base.grad_accum:
        said.append(f"grad_accum {base.grad_accum} -> {cfg.grad_accum} (the "
                    "cut batch is one microbatch)")
    else:
        said.append(f"grad_accum {cfg.grad_accum} as published ("
                    f"microbatches of {batch // cfg.grad_accum} x {seq})")
    widths = (f"{cfg.n_heads} heads of {cfg.hd}, ff {cfg.d_ff}"
              if cfg.n_heads else "")
    if cfg.family in ("ssm", "hybrid"):
        widths = (f"d_inner {cfg.d_inner}, state {cfg.ssm_state}"
                  + (f", a shared block of {widths}" if widths else ""))
    if cfg.family == "moe":
        widths += (f", {cfg.moe_num_experts} experts of ff {cfg.moe_d_ff}, "
                   f"top-{cfg.moe_top_k}")
    print(f"{label}: {arch} at its published width "
          f"({cfg.n_enc_layers or ''}{'+' if cfg.n_enc_layers else ''}"
          f"{cfg.n_layers} layers, d {cfg.d_model}, {widths}, vocab "
          f"{cfg.vocab}), bf16, remat full, random weights seeded with 0 "
          f"drawn on the card; cuts: {'; '.join(said)}"
          + ("; attention on the direct path (at most 2048 rows)"
             if cfg.n_heads else ""), flush=True)
    parity_cfg = cfg
    if cfg.family == "moe":
        parity_cfg = dataclasses.replace(cfg, n_layers=MOE_PARITY_LAYERS)
        print(f"{label}: check (a) at {MOE_PARITY_LAYERS} of "
              f"{cfg.n_layers} layers (two float32 gradient trees of the "
              "full-width model)", flush=True)
    grad_parity(torch, label, parity_cfg, shape)
    torch.cuda.empty_cache()
    if "n_layers" in cuts:
        cfg = dataclasses.replace(cfg, n_layers=cuts["n_layers"])

    ckpt = tempfile.mkdtemp(prefix="widesa_train_")
    tcfg = TrainConfig(base_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                       total_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
                       log_every=5)
    try:
        trainer = Trainer(cfg, shape, ckpt_dir=ckpt, tcfg=tcfg,
                          device="cuda")
        before = planned.planned_report()
        reset_counts()
        t0 = time.perf_counter()
        params, opt, history = trainer.run(TRAIN_STEPS, resume=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, variants = read_counts(), read_variants()
        report = planned.report_delta(before, planned.planned_report())
        sites = check_train_sites(label, report)
        head, tail = history[:5], history[-5:]
        if not all(map(math.isfinite, history)) \
                or sum(tail) / 5 >= sum(head) / 5:
            fail(f"{label}: losses {history}: not finite, or the last 5 "
                 "steps' mean not below the first 5's")
        gemms = train_launches(label, cfg, launches, variants)
        print(f"{label}: Trainer ran {TRAIN_STEPS} steps (peak lr "
              f"{TRAIN_LR}, warmup {TRAIN_WARMUP}, checkpoints every "
              f"{TRAIN_CKPT_EVERY}) in {wall:.1f} s: losses "
              f"{[round(x, 4) for x in history]}, mean of the first 5 "
              f"{sum(head) / 5:.4f} > of the last 5 {sum(tail) / 5:.4f}; "
              f"{len(sites)} sites planned with no fallback (every forward "
              f"site's /bwd_* sites among them); GEMM launches by kernel "
              f"{gemms}", flush=True)
        if cfg.n_layers != base.n_layers:
            print(f"{label}: cut: {depth_cut(base, cfg, params)}",
                  flush=True)
        saved = [t.cpu() for t in tree.leaves(params)]
        timing = train_timings(torch, label, trainer, params, opt,
                               device_name)
        peak = torch.cuda.max_memory_allocated()
        card = torch.cuda.get_device_properties(0).total_memory
        if peak > card:
            fail(f"{label}: allocated peak {gib(peak)} past the card's "
                 f"{gib(card)}")
        del trainer, params, opt
        torch.cuda.empty_cache()
        resumed, _, _ = Trainer(cfg, shape, ckpt_dir=ckpt, tcfg=tcfg,
                                device="cuda").run(0, resume=True)
        same = latest_step(ckpt) == TRAIN_STEPS and all(
            torch.equal(a.cpu(), b) for a, b in zip(tree.leaves(resumed),
                                                     saved))
        if not same:
            fail(f"{label}: a fresh Trainer did not resume at step "
                 f"{TRAIN_STEPS} with the saved parameters bit for bit")
        print(f"{label}: a fresh Trainer resumed at step {TRAIN_STEPS} with "
              f"the saved parameters bit for bit "
              f"({len(tree.leaves(resumed))} leaves); allocated peak of the "
              f"training run {gib(peak)} of the card's {gib(card)}",
              flush=True)
        del resumed, saved
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    shapes = count_shapes(report, [(k, s) for _, k, s, *_ in
                                   TRAIN_SHAPES[label]])
    rows = gemm_timings(torch, TRAIN_SHAPES[label], seed=19, long_sums=True)
    return {"launches": launches, "variants": variants, "rows": rows,
            "per_step": {key: n / TRAIN_STEPS for key, n in shapes.items()},
            "timing": timing}


#: the rest of single-card training (label, arch, tokens a sequence,
#: sequences a step, steps, config changes): qwen1.5-0.5b at train_4k's
#: published 4096-token sequences (blockwise attention, above 2048 rows,
#: in the forward, the recompute and the backward), 8 a step as
#: ``grad_accum`` 4 microbatches of 2, 3 steps (~10.8 s each: the blockwise
#: loop launches ~320 k kernels a step); llava-next-mistral-7b, 8 requests
#: of 576 patch rows and 512 text tokens, cut to 24 of 32 layers: at 14
#: bytes a parameter a mistral layer's 218 M take 2.85 GiB, and 32 layers
#: plus the embeddings, head and patch projection 94.6 GiB; 24 ran twice
#: out of two at a 75.17 GiB peak of the card's 79.18 (26 would add 5.7)
SLICE_TRAIN = (("train_4k", ARCH, 4096, 8, 3, {"grad_accum": 4}),
               ("llava_train", DENSE_ARCHS["llava"], 576 + 512, 8, 5,
                {"n_layers": 24}))
#: check (a) of the llava phase: two float32 gradient trees at this depth
LLAVA_PARITY_LAYERS = 2


def slice_train_phase(torch, device_name: str, label: str, arch: str,
                      seq: int, batch: int, steps: int, cuts: dict) -> dict:
    """``arch`` at its published width, bf16, ``remat="full"``, at the
    cut shape and depth of ``SLICE_TRAIN``: check (a) (``grad_parity``
    on one sequence; llava at ``LLAVA_PARITY_LAYERS``), then ``steps``
    steps of the Trainer's step function from seeded weights with every
    count set to 0 just before and read just after (b: every forward and
    ``/bwd_*`` site planned but ``NEVER_COMPUTED``, no fallback, the GEMM
    launches by kernel; c: every loss finite, the last below the first),
    the host time of the steps after the first, one microbatch's loss
    and gradients on the host clock and traced (device busy by kernel,
    idle share), the allocated peak; then ``TRAIN_SHAPES[label]`` timed.
    Returns the path's launches, launches by kernel, timed rows and
    launches a step of each timed shape."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES, ShapeSpec
    from repro_torch.kernels import planned
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.loop import batch_tensors
    from repro_torch.train.step import value_and_grad

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = get_config(arch)
    cfg = dataclasses.replace(base, **cuts)
    if cfg.remat != "full" or cfg.dtype != "bfloat16":
        fail(f"{label}: {arch} is not bf16 with remat='full'")
    full = SHAPES["train_4k"]
    rows = seq - cfg.vlm_patches
    micro = batch // cfg.grad_accum
    said = (f"{full.name}'s {full.seq_len} tokens x {full.global_batch} "
            f"cut to {seq} x {batch} a step, grad_accum {base.grad_accum} "
            f"-> {cfg.grad_accum} (microbatches of {micro} x {seq}), "
            f"{steps} steps; attention blockwise ({seq} > 2048 rows) in "
            "the forward, the recompute and the backward"
            if cfg.family == "dense" else
            f"{batch} requests of {cfg.vlm_patches} seeded patch rows and "
            f"{rows} text tokens a step ({batch * seq} rows), grad_accum "
            f"{cfg.grad_accum}, {steps} steps; {base.n_layers} layers cut "
            f"to {cfg.n_layers}; attention on the direct path (at most "
            "2048 rows)")
    print(f"{label}: {arch} at its published width ({cfg.n_layers} layers, "
          f"d {cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}), bf16, remat full, random "
          f"weights seeded with 0 drawn on the card; cuts: {said}",
          flush=True)
    parity_cfg = cfg
    if cfg.family == "vlm":
        parity_cfg = dataclasses.replace(cfg, n_layers=LLAVA_PARITY_LAYERS)
        print(f"{label}: check (a) at {LLAVA_PARITY_LAYERS} of "
              f"{cfg.n_layers} layers (two float32 gradient trees of the "
              "full-width model)", flush=True)
    grad_parity(torch, label, parity_cfg, ShapeSpec("card", "train", seq, 1))
    torch.cuda.empty_cache()

    shape = ShapeSpec("card", "train", seq, batch)
    tcfg = TrainConfig(base_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                       total_steps=steps)
    ckpt = tempfile.mkdtemp(prefix="widesa_slice_")  # the steps save none
    trainer = Trainer(cfg, shape, ckpt_dir=ckpt, tcfg=tcfg, device="cuda")
    params, opt = trainer.init_state()
    torch.cuda.synchronize()
    before = planned.planned_report()
    reset_counts()
    history, walls = [], []
    for step in range(steps):
        data = batch_tensors(trainer.data.batch(step), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = trainer.step_fn(params, opt, data, step)
        history.append(float(metrics["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
    launches, variants = read_counts(), read_variants()
    report = planned.report_delta(before, planned.planned_report())
    sites = check_train_sites(label, report)
    if not all(map(math.isfinite, history)) or history[-1] >= history[0]:
        fail(f"{label}: losses {history}: not finite, or the last not "
             "below the first")
    gemms = train_launches(label, cfg, launches, variants)
    # one microbatch's loss and gradients: on the host clock, then traced
    part = {k: v[:micro] for k, v in data.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value_and_grad(trainer.api.loss, params, part)
    torch.cuda.synchronize()
    micro_ms = (time.perf_counter() - t0) * 1e3
    _, ms, n_kernels, top = profiled(
        torch, lambda: value_and_grad(trainer.api.loss, params, part))
    wall = sorted(walls[1:])[len(walls[1:]) // 2]
    busy = sum(ms.values())
    tokens = batch * seq
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    gemm = {k: round(v, 3) for k, v in ms.items()
            if k in GEMM_KERNELS or k == "torch.matmul"}
    print(f"{label}: {steps} steps, losses "
          f"{[round(x, 4) for x in history]}; {len(sites)} sites planned "
          f"with no fallback (every forward site's /bwd_* sites among them"
          + (", but vlm.patch_proj/bwd_dx, never computed"
             if cfg.family == "vlm" else "")
          + f"); GEMM launches by kernel {gemms}; a step {wall:.2f} ms on "
          f"the host clock (median of steps 2-{steps}), "
          f"{tokens / wall * 1e3:.0f} tokens/s; one microbatch's loss and "
          f"gradients ({micro} x {seq}) {micro_ms:.2f} ms host, traced: "
          f"device busy {busy:.2f} ms in {n_kernels} kernels (GEMMs by "
          f"kernel {gemm}, other {ms['other']:.2f}; the largest (name, ms, "
          f"launches): {top}), device idle "
          f"{max(0.0, 1 - busy / micro_ms):.0%}; allocated peak "
          f"{gib(peak)} of the card's {gib(card)}; on {device_name} "
          f"[{nvidia_smi()}]", flush=True)
    if cfg.n_layers != base.n_layers:
        print(f"{label}: cut: {depth_cut(base, cfg, params)}", flush=True)
    if peak > card:
        fail(f"{label}: allocated peak {gib(peak)} past the card's "
             f"{gib(card)}")
    del trainer, params, opt, metrics, data, part
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    shapes = count_shapes(report, [(k, s) for _, k, s, *_ in
                                   TRAIN_SHAPES[label]])
    rows = gemm_timings(torch, TRAIN_SHAPES[label], seed=19, long_sums=True)
    print(f"{label}: the phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"launches": launches, "variants": variants, "rows": rows,
            "per_step": {key: n / steps for key, n in shapes.items()}}


def dots_phase(torch, device_name: str) -> dict:
    """One step (loss and gradients) of full-width qwen1.5-0.5b, bf16, 8 x
    512 tokens, under ``remat="dots"`` beside the same step under
    ``full`` and ``none``: each one's allocated peak above what was
    allocated before it (the weights, the batch and, before the dots
    step, full's gradients, held for the comparison), and the dots step's
    gradients against ``full``'s within ``GRAD_RTOL`` relative L2 per
    leaf.  The ops ``_dots_policy`` saves in the dots step are tallied:
    with every product planned it saves none, as the reference's policy
    saves nothing inside its ``custom_vjp``s, so the dots step's peak
    must not pass full's by more than ``DOTS_PEAK_SLACK``.  The dots
    step's launches are the ``train_dots`` path's (every count set to 0
    just before it)."""
    import collections
    import dataclasses

    from torch.utils.checkpoint import CheckpointPolicy

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import SyntheticPipeline
    from repro_torch.kernels import planned
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    from repro_torch.train.loop import batch_tensors
    from repro_torch.train.step import value_and_grad

    torch.cuda.empty_cache()
    cfg = get_config(ARCH)
    params = build_model(cfg, "cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    data = batch_tensors(SyntheticPipeline(
        cfg, ShapeSpec("card", "train", 512, 8)).batch(0), "cuda")
    decisions = collections.Counter()
    policy = T._dots_policy

    def tallied(ctx, func, *args, **kwargs):
        decision = policy(ctx, func, *args, **kwargs)
        decisions[(str(func), decision == CheckpointPolicy.MUST_SAVE)] += 1
        return decision

    peaks, grads, hosts = {}, {}, {}
    for mode in ("none", "full", "dots"):
        api = build_model(dataclasses.replace(cfg, remat=mode), "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        if mode == "dots":
            before = planned.planned_report()
            reset_counts()
            T._dots_policy = tallied
        t0 = time.perf_counter()
        try:
            loss, g = value_and_grad(api.loss, params, data)
            torch.cuda.synchronize()
        finally:
            T._dots_policy = policy
        hosts[mode] = (time.perf_counter() - t0) * 1e3
        peaks[mode] = torch.cuda.max_memory_allocated() - base
        if mode != "none":
            grads[mode] = (float(loss), g)
        del g
    launches, variants = read_counts(), read_variants()
    saved = {op: n for (op, save), n in decisions.items() if save}
    recomputed = sum(n for (_, save), n in decisions.items() if not save)
    grad_bytes = sum(t.numel() * t.element_size()
                     for t in tree.leaves(grads["full"][1]))
    sites = check_train_sites("train_dots", planned.report_delta(
        before, planned.planned_report()))
    gemms = train_launches("train_dots", cfg, launches, variants)
    (loss_f, g_f), (loss_d, g_d) = grads["full"], grads["dots"]
    errs = sorted(((float((a.double() - b.double()).norm()
                          / b.double().norm().clamp(min=1e-30)), path)
                   for path, a, b in zip(tree.paths(g_d), tree.leaves(g_d),
                                         tree.leaves(g_f))), reverse=True)
    print(f"train_dots: one step of {ARCH} at full width, bf16, 8 x 512 "
          f"tokens: allocated peak above what the step found allocated "
          f"{gib(peaks['dots'])} under dots, {gib(peaks['full'])} under "
          f"full, {gib(peaks['none'])} under none (the dots step found "
          f"full's gradients, {gib(grad_bytes)}, held besides); host "
          f"{hosts['dots']:.2f} / {hosts['full']:.2f} / {hosts['none']:.2f} "
          f"ms; _dots_policy saved {saved or 'no op'} and recomputed "
          f"{recomputed} op calls; loss {loss_d:.6f} vs full's "
          f"{loss_f:.6f}; gradient leaves' relative L2 error against "
          f"full's: largest {errs[0][0]:.3g} ({errs[0][1]}) (bound "
          f"{GRAD_RTOL}); {len(sites)} sites planned, no fallback (dots "
          f"saves no planned product: the reference's "
          f"dots_with_no_batch_dims_saveable sees no dot inside its "
          f"custom_vjp either); GEMM launches by kernel {gemms}; on "
          f"{device_name}", flush=True)
    if errs[0][0] > GRAD_RTOL or not math.isfinite(errs[0][0]) \
            or abs(loss_d - loss_f) > GRAD_RTOL * abs(loss_f):
        fail(f"train_dots: gradients under dots differ from full's: "
             f"{errs[:5]}")
    if saved or peaks["dots"] > peaks["full"] + DOTS_PEAK_SLACK:
        fail(f"train_dots: dots saved {saved} or peaked "
             f"{gib(peaks['dots'])} past full's {gib(peaks['full'])} by "
             f"more than {gib(DOTS_PEAK_SLACK)}")
    del params, grads, data
    torch.cuda.empty_cache()
    return {"launches": launches, "variants": variants, "rows": {},
            "per_step": {}}


#: how far the dots step's allocated peak may pass full's: the
#: allocator's rounding, well under one saved product a layer (8 x 512 x
#: 1024 bf16 in each of 24 layers is 192 MiB)
DOTS_PEAK_SLACK = 64 << 20

#: the race of ``autotune_phase``: each spec's smoke proxy on this mesh
RACE_MESH = (1, 8)


def no_xla_stamp() -> None:
    """Every (kind, shape, dtype) the planned facade planned in this run
    (the serving and training paths) misses the port's crossover table
    under the default ``cached`` policy: modelled, and on the hand kernel
    (``pallas``), but for the fused ``mm+mm`` and fft2d chains, whose
    stamp stays the reference's ``xla``."""
    from repro_torch.kernels import planned

    seen = planned.observed_requests()
    bad = []
    for kind, shape, dtype in seen:
        plan = planned.plan_for(kind, shape, dtype)
        want = "xla" if "+" in kind else "pallas"
        if plan is not None and (plan.provenance != "modelled"
                                 or plan.backend != want):
            bad.append((kind, shape, dtype, plan.backend, plan.provenance))
    if bad:
        fail(f"paths planned off the hand kernels by the table: {bad[:8]}")
    print(f"autotune: the {len(seen)} (kind, shape, dtype) the serving and "
          f"training paths planned all miss the crossover table "
          f"({planned.DEFAULT_POLICY}): modelled, pallas but for the fused "
          f"chains' xla", flush=True)


def table_backends(key: str) -> set:
    """The backends a committed table times at ``key``, the reference's:
    the hand kernel and the plain version, and at mesh1x1, which one card
    builds, the chip-level schedules (a fused chain's one-mesh one)."""
    if not key.endswith("|mesh1x1"):
        return {"pallas", "xla"}
    chip = ({"fused_systolic"} if "+" in key.split("|")[0]
            else {"systolic", "allgather"})
    return {"pallas", "xla"} | chip


def autotune_phase(torch, device_name: str) -> dict:
    """The measured race with the port's own crossover table: the
    committed table loads, names its card, and holds every
    ``registry.autotune_cases`` and serving-census key on meshes 1x1 and
    1x8 and the census's two-level keys under the serving hierarchical
    target, each entry with the reference's backends timed
    (``table_backends``); each spec's smoke proxy is
    raced on every dtype its cases run on (``autotune.exec_dtype``), on
    ``RACE_MESH``, under ``measured`` into a table of its own (``pallas``
    on the hand kernel, ``xla`` the plain version, CUDA events), its
    winner the least of its timings, persisted, and served back under
    ``cached`` as a hit with no new race; ``machine_factor`` of these
    timings against the committed table.  Returns the race's
    launches."""
    import shutil
    import tempfile

    from repro_torch.core import SERVING_HIERARCHICAL_TARGET as HT
    from repro_torch.core import Target, autotune, best_plan
    from repro_torch.core.hierarchy import HierarchyError, plan_hierarchy
    from repro_torch.kernels import registry
    from repro_torch.launch.gen_autotune import serving_cases

    t0 = time.perf_counter()
    table = autotune.load_table(autotune.DEFAULT_TABLE_PATH)
    extra, chains = serving_cases()
    cases = [(spec.name, args, dtype) for spec in registry.specs()
             for dtype, args in registry.autotune_cases(spec)]
    want = {autotune.request_key(autotune.PlanRequest(
        kind, args, dtype, Target(name="t", mesh_shape=mesh)))
        for mesh in ((1, 1), (1, 8))
        for kind, args, dtype in (*cases, *extra, *chains)}
    for kind, args, dtype in extra:
        try:
            plan_hierarchy(registry.get(kind).builder(*args, dtype), HT)
        except HierarchyError:
            continue
        want.add(autotune.request_key(autotune.PlanRequest(
            kind, args, dtype, HT)))
    missing = sorted(want - set(table["entries"]))
    if missing or "H100" not in table["note"]:
        fail(f"autotune: the committed table lacks {missing[:5]} or names "
             f"no card: {table['note']!r}")
    untimed = sorted(key for key, entry in table["entries"].items()
                     if set(entry["us"]) != table_backends(key))
    if untimed:
        fail(f"autotune: the committed table does not time the "
             f"reference's backends at {untimed}")
    winners = {}
    for entry in table["entries"].values():
        winners[entry["backend"]] = winners.get(entry["backend"], 0) + 1
    # every race the table was built from: each spec's smoke proxy on each
    # dtype its cases run on, beside the committed entry of one such case
    proxies = {}
    for kind, args, dtype in cases:
        key = autotune.autotune_key(registry.get(kind).builder(*args, dtype),
                                    RACE_MESH)
        proxies.setdefault((kind, autotune.exec_dtype(kind, dtype)), key)
    target = Target(name=f"autotune_{RACE_MESH}", mesh_shape=RACE_MESH)
    tmp = Path(tempfile.mkdtemp(prefix="widesa_autotune_"))
    fresh, raced = {}, []
    reset_counts()
    try:
        for (kind, run), table_key in proxies.items():
            spec = registry.get(kind)
            rec = spec.builder(*spec.smoke_args, run)
            key = autotune.autotune_key(rec, RACE_MESH)
            path = tmp / f"{kind}_{run}.json"  # one file each: no mtime race
            autotune.save_table(path, autotune.new_table())
            measured = autotune.PlanPolicy(mode="measured",
                                           table_path=str(path), reps=5,
                                           warmup=2)
            c0 = autotune.counters()
            plan = best_plan(rec, target, policy=measured)
            entry = autotune.load_table(path)["entries"].get(key)
            c1 = autotune.counters()
            again = best_plan(rec, target, policy=autotune.PlanPolicy(
                mode="cached", table_path=str(path)))
            c2 = autotune.counters()
            ok = (entry is not None
                  and entry["backend"] == min(entry["us"],
                                              key=entry["us"].get)
                  and set(entry["us"]) == {"pallas", "xla"}
                  and plan.backend == again.backend == entry["backend"]
                  and plan.provenance == again.provenance == "measured"
                  and c1["measure_calls"] == c0["measure_calls"] + 1
                  and c2["hits"] == c1["hits"] + 1
                  and c2["measure_calls"] == c1["measure_calls"])
            if not ok:
                fail(f"autotune: {key}: entry {entry}, plan "
                     f"{plan.backend}/{plan.provenance}, served "
                     f"{again.backend}/{again.provenance}, counters {c0} "
                     f"{c1} {c2}")
            committed = table["entries"][table_key]
            if committed["measured_dtype"] != run:
                fail(f"autotune: {table_key} was raced on "
                     f"{committed['measured_dtype']}, not {run}")
            fresh[table_key] = entry["us"][entry["backend"]]
            raced.append((key, entry["backend"], entry["us"],
                          committed["backend"], committed["us"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches, variants = read_counts(), read_variants()
    factor = autotune.machine_factor(table, fresh)
    print(f"autotune: the committed table ({len(table['entries'])} entries, "
          f"winners {winners}; {table['note']!r}) holds every one of the "
          f"{len(want)} registry, census and two-level census keys, each "
          f"with the reference's backends "
          f"timed; raced each spec's smoke proxy on each dtype its cases "
          f"run on ({len(raced)} races), mesh "
          f"{'x'.join(map(str, RACE_MESH))}, CUDA events, median of 5 after "
          f"2 (key, winner, us, committed winner, committed us): {raced}; "
          f"each persisted and served back as a hit with no new race; "
          f"machine_factor of these timings against the committed table "
          f"{factor:.3f}; the race's launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s on {device_name}", flush=True)
    return {"launches": launches, "variants": variants, "rows": {},
            "per_step": {}}


def iter_tensors(tree):
    """Every tensor of a parameter tree (dicts and lists)."""
    if isinstance(tree, dict):
        tree = tree.values()
    for node in tree:
        if isinstance(node, (dict, list)):
            yield from iter_tensors(node)
        else:
            yield node


# ---------------------------------------------------------------------------
# recurrences: the mapper -> kernel pipeline, B6 and B7
# ---------------------------------------------------------------------------

#: B6 and B7 at the registry's bench sizes and at ragged ones (outputs not
#: multiples of any compiled tile), as builder arguments
HPC_BENCH = {"jacobi2d": (10238, 10238), "jacobi2d_9pt": (10236, 10236),
             "jacobi2d_ms": (4094, 4094, 8), "mttkrp": (4096, 400, 256, 256)}
HPC_RAGGED = {"jacobi2d": (61, 59), "jacobi2d_9pt": (61, 59),
              "jacobi2d_ms": (61, 59, 3), "mttkrp": (37, 45, 7, 5)}
#: the shapes and dtypes timed, the first of each kernel its kernels-line row
HPC_TIMED = (("jacobi2d", "float32"), ("jacobi2d", "int8"),
             ("jacobi2d", "int16"), ("jacobi2d_9pt", "float32"),
             ("jacobi2d_ms", "float32"),
             ("mttkrp", "float32"), ("mttkrp", "int8"), ("mttkrp", "int16"),
             ("mttkrp", "int32"))
#: int8 products a product of the tensor-core MTTKRP: the limb pairs p,
#: q with p + q < 4
LIMB_PRODUCTS = {"int8": 1, "int16": 4, "int32": 10}
#: the profiler's name of each MTTKRP kernel (``mttkrp.variants`` keys)
MTTKRP_KERNELS = {"tensor_core": "mttkrp_tc_kernel",
                  "cuda_core": "mttkrp_kernel"}


def mttkrp_variant(tile) -> str:
    """The MTTKRP kernel a tile launches (a key of ``mttkrp.variants``)."""
    from repro_torch.kernels import runtime

    return "tensor_core" if isinstance(tile, runtime.MttkrpTile) \
        else "cuda_core"


def mttkrp_expected(args, dtype) -> str:
    """The kernel MTTKRP must run on at ``args`` in ``dtype``: the tensor
    cores where the rows of X and B allow 4-byte copies (every float32 and
    int32 shape; int8 with J and L multiples of 4; int16 with J and L
    even) and C's tile fits in shared memory, else the CUDA cores."""
    import torch

    from repro_torch.kernels import runtime

    nj, nl = args[1], args[3]
    unit = {"float32": 1, "int32": 1, "int16": 2, "int8": 4}[dtype]
    fits = runtime.mttkrp_smem(nl, getattr(torch, dtype)) \
        <= runtime.MTTKRP_TC_MAX_SMEM
    return "tensor_core" if fits and nj % unit == 0 and nl % unit == 0 \
        else "cuda_core"


def hpc_call(name, args, dtype):
    """The B6 / B7 wrapper at the tile the runtime maps the single-chip
    plan onto: (call, spec, recurrence, HopperTiles)."""
    from repro_torch.core import Target, best_plan
    from repro_torch.kernels import jacobi2d, mttkrp, registry

    spec = registry.get(name)
    rec = spec.builder(*args, dtype)
    plan = best_plan(rec, Target(name="single_chip", mesh_shape=(1, 1)))
    fn = mttkrp.mttkrp if name == "mttkrp" else getattr(jacobi2d, name)
    return fn, spec, rec, plan


def hpc_parity(torch) -> None:
    """B6 and B7 against their plain versions at the bench and ragged
    sizes, in every dtype they take (the multi-sweep form on its int32
    state too), on the launch the runtime maps the plan onto; the
    multi-sweep form in ceil(T / T_b) launches and, in float32, bitwise
    equal to one launch a sweep (T_b = 1); then a TF32 control, which
    ``recurrences.compare`` must reject."""
    from repro_torch.kernels import jacobi2d, registry, runtime
    from repro_torch.launch import recurrences

    gen = torch.Generator(device="cuda").manual_seed(7)
    n, worst, routes, fused = 0, {}, {}, {}
    for name in HPC_BENCH:
        for args in (HPC_RAGGED[name], HPC_BENCH[name]):
            for dtype in ("float32", "int8", "int16", "int32"):
                fn, spec, rec, plan = hpc_call(name, args, dtype)
                ops = registry.operands(rec, gen, "cuda")
                tile = spec.tiles(plan, *ops).tile
                if name == "mttkrp":
                    kernel = mttkrp_variant(tile)
                    if kernel != mttkrp_expected(args, dtype):
                        fail(f"mttkrp{args} {dtype}: routed to {kernel} "
                             f"({tile})")
                    routes[(args, dtype)] = kernel
                elif not isinstance(tile, runtime.SweepTile
                                    if name == "jacobi2d_ms"
                                    else runtime.StarTile):
                    fail(f"{name}{args}: launch {tile}")
                want = spec.ref(*ops)
                before = jacobi2d.launches
                out = fn(*ops, tiles=tile)
                torch.cuda.synchronize()
                err, ok = recurrences.compare(spec, rec, ops, out, want)
                if not ok:
                    fail(f"{name}{args} {dtype}: max |err| {err} outside "
                         "tolerance")
                if name == "jacobi2d_ms":
                    t = rec.extent("t")
                    if jacobi2d.launches - before != tile.launches(t):
                        fail(f"{name}{args}: {jacobi2d.launches - before} "
                             f"launches on {tile}, not {tile.launches(t)}")
                    if dtype == "float32":
                        one = fn(*ops, tiles=runtime.SweepTile(sweeps=1))
                        if not torch.equal(out, one):
                            fail(f"{name}{args} float32: {tile} differs "
                                 "from one launch a sweep")
                        fused[args] = f"{tile.launches(t)} launch(es) of " \
                            f"T_b = {tile.sweeps} == {t} of T_b = 1, bitwise"
                worst[(name, dtype)] = max(worst.get((name, dtype), 0.0),
                                           err)
                n += 1
                del ops, want, out
                torch.cuda.empty_cache()
    floats = {k[0]: f"{v:.4g}" for k, v in worst.items() if k[1] == "float32"}
    routed = {f"{args} {dtype}": kernel
              for (args, dtype), kernel in routes.items()}
    print(f"recurrences: B6/B7 parity ok in {n} cases (4 specs x bench and "
          f"ragged sizes x 4 dtypes; integers bit-exact; float32 max |err| "
          f"{floats} within recurrences.float_bound); jacobi2d_ms float32 "
          f"{fused}; mttkrp kernels {routed}", flush=True)
    tf32_control(torch, gen)


def tf32_control(torch, gen) -> None:
    """The float32 bound must catch a precision loss at MTTKRP's bench
    size: the plain version with TF32 GEMMs (10-bit significands) held
    against the fp32 plain version fails ``recurrences.compare``."""
    from repro_torch.kernels import registry
    from repro_torch.launch import recurrences

    _, spec, rec, _ = hpc_call("mttkrp", HPC_BENCH["mttkrp"], "float32")
    ops = registry.operands(rec, gen, "cuda")
    want = spec.ref(*ops)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = spec.ref(*ops)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    err, ok = recurrences.compare(spec, rec, ops, control, want)
    bound = recurrences.float_bound(spec, rec, ops)
    print(f"recurrences: TF32 control of mttkrp{HPC_BENCH['mttkrp']} "
          f"float32: max |err| {err:.4g} against float_bound "
          f"{bound.min().item():.4g}-{bound.max().item():.4g} "
          f"({'ok' if ok else 'not ok'}: the bound "
          f"{'MISSES' if ok else 'catches'} a TF32 rounding)", flush=True)
    if ok:
        fail("recurrences.float_bound accepts the TF32 control")
    del ops, want, control, bound
    torch.cuda.empty_cache()


def hpc_bound_ms(name, rec, in_bytes, out_bytes, rate="float32",
                 passes=1):
    """Least time for one call (``least_ms``): each operand read once and
    the result written once, or the folded operations at the peak rate
    of ``rate`` (the fp32 CUDA-core rate unless asked otherwise), each
    done ``passes`` times (3 for 3xTF32).  For jacobi2d_ms that is the
    whole function (grid in, result out, 2 S T operations an output);
    mttkrp counts 2 I J K L operations (one multiply-add per (i, j, k, l)
    once B C is folded), not the IR's ops_per_point = 3."""
    e = {loop: rec.extent(loop) for loop in rec.loops}
    if name == "mttkrp":
        moved = (e["i"] * e["k"] * e["l"] + (e["k"] + e["l"]) * e["j"]) \
            * in_bytes + e["i"] * e["j"] * out_bytes
        ops = 2 * e["i"] * e["j"] * e["k"] * e["l"] * passes
        return least_ms(moved, ops, rate)
    pad = 4 if name == "jacobi2d_9pt" else 2
    sweeps = e.get("t", 1)
    moved = ((e["i"] + pad) * (e["j"] + pad) + sweeps * e["s"]) * in_bytes \
        + e["i"] * e["j"] * out_bytes
    return least_ms(moved, 2 * e["s"] * sweeps * e["i"] * e["j"], rate)


def host_call_ms(torch, fn, calls=20) -> float:
    """Host time of one call of ``fn`` that the card finishes: ``calls``
    calls on the host clock, each followed by a synchronisation."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def hpc_library(torch, name, ops):
    """One PyTorch call computing the same function on float32 copies, TF32
    off (yardstick only), or None: ``F.conv2d`` with the star as a
    zero-padded (2r+1)^2 filter, ``torch.einsum`` for mttkrp; the
    multi-sweep stencil has no one call."""
    import torch.nn.functional as F

    from repro_torch.core.recurrence import (JACOBI2D_9PT_OFFSETS,
                                             JACOBI2D_OFFSETS)

    if name == "mttkrp":
        x, b, c = (o.float() for o in ops)
        return lambda: torch.einsum("ikl,kj,lj->ij", x, b, c)
    if name == "jacobi2d_ms":
        return None
    offsets = JACOBI2D_9PT_OFFSETS if name == "jacobi2d_9pt" \
        else JACOBI2D_OFFSETS
    size = max(max(pt) for pt in offsets) + 1
    grid, weights = ops[0].float()[None, None], ops[1].float()
    filt = torch.zeros((1, 1, size, size), device="cuda")
    for s, (di, dj) in enumerate(offsets):
        filt[0, 0, di, dj] = weights[s]
    return lambda: F.conv2d(grid, filt)


def sweep_launches(call) -> int:
    """The launches one ``call`` of ``jacobi2d_ms`` makes, read from
    ``jacobi2d.launches`` around it; fails unless ``jacobi2d.variants``
    counts each under "sweeps"."""
    from repro_torch.kernels import jacobi2d

    before, sweeps = jacobi2d.launches, jacobi2d.variants["sweeps"]
    call()
    n = jacobi2d.launches - before
    if jacobi2d.variants["sweeps"] - sweeps != n:
        fail(f"jacobi2d_ms: {n} launches, "
             f"{jacobi2d.variants['sweeps'] - sweeps} counted as sweeps")
    return n


def hpc_timings(torch) -> dict:
    """B6 and B7 at the bench sizes (``HPC_TIMED``): kernel (CUDA events
    and ``torch.profiler`` device time), plain version, library call and
    bound.  MTTKRP rows on the tensor cores also give the CUDA-core
    kernel's device time on the same operands, and their bound at the
    tensor-core rate (3xTF32: three TF32 products a product; int16 and
    int32: 4 and 10 int8 limb products) beside the fp32 CUDA-core one."""
    from repro_torch.kernels import build, registry, runtime

    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = {}
    for name, dtype in HPC_TIMED:
        fn, spec, rec, plan = hpc_call(name, HPC_BENCH[name], dtype)
        ops = registry.operands(rec, gen, "cuda")
        tiles = spec.tiles(plan, *ops)
        reps = 5 if name == "mttkrp" else 10
        out = fn(*ops, tiles=tiles.tile)
        want = spec.ref(*ops)
        err = (out.double() - want.double()).abs().max().item()
        lib = hpc_library(torch, name, ops)
        kname = MTTKRP_KERNELS[mttkrp_variant(tiles.tile)] \
            if name == "mttkrp" else "sweeps_kernel" \
            if name == "jacobi2d_ms" else "star_kernel"
        per_call = 1
        if name == "jacobi2d_ms":
            # the launches of one call, as the wrapper's counters read them
            per_call = sweep_launches(lambda: fn(*ops, tiles=tiles.tile))
            if per_call != tiles.tile.launches(rec.extent("t")):
                fail(f"jacobi2d_ms{HPC_BENCH[name]} {dtype}: {per_call} "
                     f"launches on {tiles.tile}")
        row = dict(
            tiles=tiles, max_abs_err=err,
            ms=time_ms(torch, lambda: fn(*ops, tiles=tiles.tile), reps, 2),
            plain_ms=time_ms(torch, lambda: spec.ref(*ops), reps, 2),
            library_ms=None if lib is None else time_ms(torch, lib, reps, 2),
            device_ms=device_ms(torch, lambda: fn(*ops, tiles=tiles.tile),
                                kname, reps, per_call),
            library_device_ms=None if lib is None
            else device_ms(torch, lib, None, reps),
        )
        row["bound_ms"], row["bound_by"] = hpc_bound_ms(
            name, rec, ops[0].element_size(), out.element_size())
        rate = ", fp32 CUDA-core rate" \
            if row["bound_by"] == "operations" else ""
        extra = ""
        if name in ("jacobi2d", "jacobi2d_9pt"):
            # the card's own copy of the same bytes: the grid's interior,
            # converted to the output's dtype (PyTorch's copy_)
            pad = 2 if name == "jacobi2d_9pt" else 1
            view = ops[0][pad:-pad, pad:-pad]
            row["copy_device_ms"] = device_ms(torch, lambda: out.copy_(view))
            extra = (f"; a copy_ of the same bytes "
                     f"{fmt_ms(row['copy_device_ms'])}")
        if name == "mttkrp" and mttkrp_variant(tiles.tile) == "tensor_core":
            row["cuda_core_device_ms"] = device_ms(
                torch, lambda: fn(*ops, tiles=build.MTTKRP_TILE),
                MTTKRP_KERNELS["cuda_core"], reps)
            # 3xTF32: three TF32 products a product; the integers one int8
            # product a pair of limbs (1, 4 and 10 in int8, int16, int32)
            tc_rate, passes = ("tfloat32", 3) if dtype == "float32" \
                else ("int8", LIMB_PRODUCTS[dtype])
            tc_ms, tc_by = hpc_bound_ms(
                name, rec, ops[0].element_size(), out.element_size(),
                rate=tc_rate, passes=passes)
            # the kernels line's bound: the tensor-core rate its work runs at
            row["cuda_core_bound_ms"] = row["bound_ms"]
            row["bound_ms"], row["bound_by"] = tc_ms, tc_by
            rate = (f", {'3xTF32' if dtype == 'float32' else 'int8'} "
                    f"tensor-core rate, {passes} product(s) a product"
                    if tc_by == "operations" else "")
            extra = (f"; fp32 CUDA-core bound "
                     f"{row['cuda_core_bound_ms']:.4f} ms; CUDA-core kernel "
                     f"device time {fmt_ms(row['cuda_core_device_ms'])}")
        rows[(name, dtype)] = row
        if name == "jacobi2d_ms":
            sweeps = rec.extent("t")
            row["launches"] = per_call
            row["floor_ms"] = sweeps * hpc_bound_ms(
                "jacobi2d", registry.get("jacobi2d").builder(
                    rec.extent("i"), rec.extent("j"), dtype), 4, 4)[0]
            row["host_ms"] = host_call_ms(
                torch, lambda: fn(*ops, tiles=tiles.tile))
            # the device time of a call with each T_b (the launches' sum)
            row["device_ms_by_sweeps"] = {}
            for tb in (1, 2, 4, 8):
                call = lambda tb=tb: fn(*ops, tiles=runtime.SweepTile(tb))
                row["device_ms_by_sweeps"][tb] = device_ms(
                    torch, call, kname, reps, sweep_launches(call))
            by = ", ".join(f"{tb}: {fmt_ms(v)}" for tb, v in
                           row["device_ms_by_sweeps"].items())
            extra = (f"; {per_call} launch(es) a call (T_b = "
                     f"{tiles.tile.sweeps}), host clock {row['host_ms']:.4f}"
                     f" ms a synchronized call, device {fmt_ms(row['device_ms'])} "
                     f"a call; the whole call's bound {row['bound_ms']:.4f} "
                     f"ms beside the floor of {sweeps} separate passes "
                     f"{row['floor_ms']:.4f} ms; device ms a call by T_b "
                     f"{{{by}}}")
        library = ("none (no one call)" if lib is None else
                   f"{row['library_ms']:.4f} ms (device "
                   f"{fmt_ms(row['library_device_ms'])})")
        print(f"time {name}{HPC_BENCH[name]} {dtype} plan block "
              f"{tiles.plan} -> tile {tiles.tile}: kernel {row['ms']:.4f} "
              f"ms (kernel device time {fmt_ms(row['device_ms'])}), plain "
              f"{row['plain_ms']:.4f} ms, library {library}, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}{rate}){extra}; "
              f"max |err| {err:.4g}", flush=True)
        del ops, out, want, lib
        torch.cuda.empty_cache()
    return rows


#: the integer GEMMs above 16 rows the recurrence pipeline runs: the
#: registry's mm and bmm smoke shapes (in int8, int16 and int32) and the
#: paper's MM/BMM table (the registry's integer bench cases: mm int8
#: 10240^3, int16 9600^3, int32 8192^3; bmm int8 and int16 64 x 4096^3)
INT_GEMMS = (("mm", (256, 256, 256)), ("bmm", (4, 128, 128, 64)))


def paper_cases(floats: bool):
    """(kind, shape, dtype name) of the registry's mm and bmm bench cases,
    the float32 or the integer ones."""
    from repro_torch.kernels import registry

    return [(kind, args, dtype) for kind in ("mm", "bmm")
            for dtype, args in registry.get(kind).bench_cases
            if (dtype == "float32") == floats]


def plain_equal(torch, kind, a, b, *outs) -> bool:
    """Whether every one of ``outs`` equals the plain version of ``a @ b``
    bitwise; a bmm batch entry by batch entry (so that the exact-integer
    temporaries stay those of one entry)."""
    from repro_torch.kernels import ref

    if kind == "mm":
        want = ref.mm(a, b)
        return all(torch.equal(out, want) for out in outs)
    for z in range(a.shape[0]):
        want = ref.mm(a[z], b[z])
        if not all(torch.equal(out[z], want) for out in outs):
            return False
    return True


def int_gemm_timings(torch) -> dict:
    """The integer GEMMs above 16 rows (``INT_GEMMS`` in int8, int16 and
    int32, and the paper's table, ``paper_cases``) on the kernel the
    runtime routes them to, which must be the tensor-core one, held
    bitwise to the plain version (a bmm batch entry by batch entry), as is
    the tiled kernel's result: ``torch.profiler`` device time of
    ``gemm_tc_int_kernel`` and of its limb-plane pre-pass
    (``limb_planes_kernel``, one launch for both operands), the achieved
    TOP/s, the bound (the int8
    tensor-core rate x 1, 4 or 10 limb products, or the bytes), the tiled
    kernel it replaces on the same operands (profiler device time at the
    smoke shapes, CUDA events around one call at the paper's), the plain
    version and, for int8 mm, ``torch._int_mm`` on B as given (row-major)
    and on a column-major copy (the layout cuBLAS's int8 kernels take),
    beside the new route on that copy.  Returns the rows by (kind, shape,
    dtype name)."""
    from repro_torch.kernels import runtime

    gen = torch.Generator(device="cuda").manual_seed(13)
    cases = [(kind, shape, name, False) for kind, shape in INT_GEMMS
             for name in ("int8", "int16", "int32")]
    cases += [(*case, True) for case in paper_cases(floats=False)]
    rows = {}
    for kind, shape, name, paper in cases:
        dtype = getattr(torch, name)
        a, b = operands(torch, gen, kind, shape, dtype, False)
        call, tiles = kernel_call(kind, shape, dtype, a, b)
        if not isinstance(tiles.tile, runtime.TcTile):
            fail(f"{kind}{shape} {name}: routed to {describe(tiles.tile)}, "
                 "not the tensor-core kernel")
        tiled, tile = tiled_call(kind, shape, dtype, False)
        out, slow = call(a, b), tiled(a, b)
        t0 = time.perf_counter()
        same = plain_equal(torch, kind, a, b, out, slow)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not same:
            fail(f"{kind}{shape} {name}: the tensor-core or the tiled kernel "
                 "is not bit-exact")
        del slow
        reps = 3 if paper else 10
        (m, n, k), z = shape[-3:], (shape[0] if kind == "bmm" else 1)
        gemm = device_ms(torch, lambda: call(a, b), "gemm_tc_int_kernel", reps)
        pre = device_ms(torch, lambda: call(a, b), "limb_planes_kernel", reps)
        device = None if None in (gemm, pre) else gemm + pre
        tiled_ms = time_ms(torch, lambda: tiled(a, b), 1, 1) if paper else \
            device_ms(torch, lambda: tiled(a, b), "gemm_kernel", reps)
        # at the paper's shapes the route is timed as the tiled kernel is,
        # with CUDA events (both launches, pre-pass and GEMM), for the gate
        # below: the profiler can drop a kernel's records in every trace
        events = time_ms(torch, lambda: call(a, b), reps, 1) if paper \
            else None
        ops = 2 * z * m * n * k
        moved = z * ((m * k + k * n) * dtype.itemsize + m * n * 4)
        bound, by = least_ms(moved, ops * LIMB_PRODUCTS[name], "int8")
        row = dict(tiles=tiles, device_ms=device, gemm_ms=gemm, prepass_ms=pre,
                   tops=None if device is None else ops / device / 1e9,
                   bound_ms=bound, bound_by=by, tiled_ms=tiled_ms,
                   events_ms=events,
                   tiled_timer="events, one call" if paper else "device",
                   plain_ms=plain_ms, library_ms=None, max_abs_err=0.0)
        lib_text = "none on the card" + ("" if kind == "mm" else
                                         " (torch._int_mm is 2-D)")
        if kind == "mm" and dtype == torch.int8:
            col = b.t().contiguous().t()
            got = torch._int_mm(a, b), torch._int_mm(a, col), call(a, col)
            if not plain_equal(torch, kind, a, b, *got):
                fail(f"{kind}{shape} int8: torch._int_mm or the column-major "
                     "route differs")
            del got
            row["library_ms"] = device_ms(torch, lambda: torch._int_mm(a, b),
                                          None, reps)
            row["library_col_ms"] = device_ms(
                torch, lambda: torch._int_mm(a, col), None, reps)
            row["col_ms"] = device_ms(torch, lambda: call(a, col),
                                      "gemm_tc_int_kernel", reps)
            lib_text = (f"torch._int_mm device {fmt_ms(row['library_ms'])} "
                        f"(B row-major), {fmt_ms(row['library_col_ms'])} (B "
                        f"column-major; the new route on that B, no pre-pass: "
                        f"{fmt_ms(row['col_ms'])})")
            del col
        rows[(kind, shape, name)] = row
        tops = "not measured" if row["tops"] is None else \
            f"{row['tops']:.0f} TOP/s"
        print(f"time {kind}{shape} {name} -> int32 ["
              f"{describe(tiles.tile, kind, shape)}, "
              f"{'the paper table' if paper else 'the pipeline smoke'}]: "
              f"device {fmt_ms(device)} (gemm_tc_int_kernel {fmt_ms(gemm)} + "
              f"limb_planes_kernel {fmt_ms(pre)}), {tops}, bound "
              f"{bound:.5f} ms ({by}; int8 tensor-core rate x "
              f"{LIMB_PRODUCTS[name]} product(s)); "
              + ("" if events is None else
                 f"route {fmt_ms(events)} (events, {reps} calls); ")
              + f"tiled {tile} "
              f"{fmt_ms(tiled_ms)} ({row['tiled_timer']}); library {lib_text}; "
              f"plain {plain_ms:.1f} ms (host clock); bit-exact, both kernels",
              flush=True)
        del a, b, out
        torch.cuda.empty_cache()
    below = {f"{k}{s} {d}": r["device_ms"] is not None
             and r["device_ms"] < r["tiled_ms"] for (k, s, d), r in rows.items()}
    slower = [key for key, ok in below.items() if not ok]
    print(f"time: the tensor-core route below the tiled kernel at "
          f"{len(below) - len(slower)} of {len(below)} integer shapes; not "
          f"at {slower or 'none'} (at the smoke shapes the route's two "
          f"launches, pre-pass and GEMM, each take microseconds of fixed "
          f"device time, against the tiled kernel's one launch)", flush=True)
    # the paper's table is what the route is for: it must win there, on
    # the CUDA events' clock that times both
    paper_slower = [f"{k}{s} {d}" for k, s, d in paper_cases(floats=False)
                    if not rows[(k, s, d)]["events_ms"]
                    < rows[(k, s, d)]["tiled_ms"]]
    if paper_slower:
        fail(f"integer GEMMs on the tensor cores not faster than the tiled "
             f"kernel they replace at the paper's shapes (CUDA events, both "
             f"launches of the route against the tiled kernel's one): "
             f"{paper_slower}")
    return rows


def float_paper_timings(torch) -> dict:
    """The paper's float32 MM and BMM (mm 8192^3, bmm 64 x 4096^3) on the
    tensor-core kernel (3xTF32), held to ``recurrences.held`` (the
    float bound; a bmm batch entry by batch entry): profiler device time
    beside the bound (three TF32 products a product) and
    ``torch.matmul`` / ``torch.bmm`` (fp32, TF32 off)."""
    from repro_torch.kernels import registry, runtime
    from repro_torch.launch import recurrences

    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = {}
    for kind, shape, name in paper_cases(floats=True):
        a, b = operands(torch, gen, kind, shape, torch.float32, False)
        call, tiles = kernel_call(kind, shape, torch.float32, a, b)
        if not isinstance(tiles.tile, runtime.TcTile):
            fail(f"{kind}{shape} float32: not on the tensor-core kernel")
        spec = registry.get(kind)
        err, ok = recurrences.held(spec, spec.builder(*shape, name), (a, b),
                                   call(a, b))
        if not ok:
            fail(f"{kind}{shape} float32: max |err| {err} outside "
                 "recurrences.float_bound")
        lib = torch.matmul if kind == "mm" else torch.bmm
        (m, n, k), z = shape[-3:], (shape[0] if kind == "bmm" else 1)
        bound, by = least_ms(z * (m * k + k * n + m * n) * 4,
                             3 * 2 * z * m * n * k, "tfloat32")
        row = dict(tiles=tiles, max_abs_err=err, bound_ms=bound, bound_by=by,
                   device_ms=device_ms(torch, lambda: call(a, b),
                                       "gemm_tc_kernel", 3),
                   library_ms=device_ms(torch, lambda: lib(a, b), None, 3))
        rows[(kind, shape)] = row
        print(f"time {kind}{shape} float32 [{describe(tiles.tile, kind, shape)}"
              f", the paper table, 3xTF32]: device "
              f"{fmt_ms(row['device_ms'])}, bound {bound:.4f} ms ({by}); "
              f"torch.{lib.__name__} device {fmt_ms(row['library_ms'])}; "
              f"max |err| {err:.4g} within recurrences.float_bound",
              flush=True)
        del a, b
        torch.cuda.empty_cache()
    return rows


def mttkrp_sweep(torch) -> list[dict]:
    """The tensor-core MTTKRP at the bench size in float32, int8, int16
    and int32 with every split of K over a cluster (1 to 8), each held to
    the plain version, beside the CUDA-core kernel and ``torch.einsum``
    (profiler device time)."""
    from repro_torch.kernels import build, mttkrp, registry, runtime
    from repro_torch.launch import recurrences

    gen = torch.Generator(device="cuda").manual_seed(9)
    args = HPC_BENCH["mttkrp"]
    rows = []
    for dtype in ("float32", "int8", "int16", "int32"):
        _, spec, rec, plan = hpc_call("mttkrp", args, dtype)
        ops = registry.operands(rec, gen, "cuda")
        want = spec.ref(*ops)
        picked = spec.tiles(plan, *ops).tile
        splits = {}
        for split in range(1, runtime.MTTKRP_TC_MAX_CLUSTER + 1):
            tile = runtime.MttkrpTile(split=split, copy=picked.copy)
            err, ok = recurrences.compare(
                spec, rec, ops, mttkrp.mttkrp(*ops, tiles=tile), want)
            if not ok:
                fail(f"mttkrp{args} {dtype} split {split}: max |err| {err}")
            splits[split] = device_ms(
                torch, lambda t=tile: mttkrp.mttkrp(*ops, tiles=t),
                MTTKRP_KERNELS["tensor_core"], 5)
        cuda_core = device_ms(
            torch, lambda: mttkrp.mttkrp(*ops, tiles=build.MTTKRP_TILE),
            MTTKRP_KERNELS["cuda_core"], 3)
        library = device_ms(torch, hpc_library(torch, "mttkrp", ops), None, 3)
        rows.append(dict(dtype=dtype, picked=str(picked), splits=splits,
                         cuda_core=cuda_core, library=library))
        print(f"sweep mttkrp{args} {dtype}: picked {picked}; tensor-core "
              f"device ms by split "
              f"{({k: round(v, 4) if v else v for k, v in splits.items()})}; "
              f"CUDA-core kernel {fmt_ms(cuda_core)}; torch.einsum "
              f"{fmt_ms(library)}", flush=True)
        del ops, want
        torch.cuda.empty_cache()
    return rows


def fft_sweep(torch) -> list[dict]:
    """The fused fft2d kernel at ``FFT_SHAPES``' frontend, wide and
    pipeline grids with every split of K it takes (1-8), each held to
    ``ref.fft2d``, beside the composition and ``torch.fft.fft2`` (profiler
    device time); then the FFT kernel at ``FFT_SWEEP``'s grids with every
    configuration of ``fft_configs`` (``fft_kernel_sweep``)."""
    from repro_torch.kernels import fft2d, ref, runtime

    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = []
    for shape in (FFT_MAIN, (16, 1024), FFT_PIPELINE):
        _, composition, picked = fft_kernel(shape)
        re_, im_ = (torch.randn(shape, generator=gen, device="cuda")
                    for _ in range(2))
        want = ref.fft2d(re_, im_)
        splits = {}
        for split in range(1, runtime.FFT2D_MAX_CLUSTER + 1):
            if not runtime.fft2d_allows(*shape, split):
                continue
            tile = runtime.Fft2dTile(split)
            got = fft2d.fft2d(re_, im_, tiles=tile)
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            if err > 1.0:
                fail(f"fft2d{shape} split {split}: max |err| {err}")
            splits[split] = device_ms(
                torch, lambda t=tile: fft2d.fft2d(re_, im_, tiles=t),
                "fft2d_kernel", 20)
        comp = device_ms(torch, lambda: composition(re_, im_))
        library = device_ms(
            torch, lambda: torch.fft.fft2(torch.complex(re_, im_)), None, 20)
        rows.append(dict(shape=shape, picked=str(picked), splits=splits,
                         composition=comp, library=library))
        print(f"sweep fft2d{shape}: picked {picked}; fused device ms by split "
              f"{ {k: round(v, 4) if v else v for k, v in splits.items()} }; "
              f"composition {fmt_ms(comp)}; torch.fft.fft2 {fmt_ms(library)}",
              flush=True)
    return rows + fft_kernel_sweep(torch)


#: ``--fft-sweep``'s grids for the FFT kernel: the pipeline's bench grid
#: and a tall one whose columns take a cluster
FFT_SWEEP = ((8192, 8192), (4096, 256))


def fft_configs(shape) -> list:
    """The FFT kernel's configurations of a grid that it takes: rows a
    row-pass block (1 to 8192 points' worth), columns a column-pass block
    (4 to 32) and blocks a cluster (the least that holds the strip, up to
    16).  The column pass has one design here, the cluster's
    distributed-shared-memory stage; a four-step split over two passes
    is not built."""
    from repro_torch.kernels import runtime

    r, c = shape
    out = []
    for rows in sorted({runtime.fft_config(r, c).rows,
                        max(1, runtime.FFT_ROW_POINTS // 2 // c),
                        max(1, runtime.FFT_BLOCK_POINTS // c)}):
        for strip in (4, 8, 16, 32):
            for cluster in (1, 2, 4, 8, 16):
                tile = runtime.fft_config(r, c, rows=rows, strip=strip,
                                          cluster=cluster)
                least = cluster == 1 \
                    or r // cluster * strip * 2 > runtime.FFT_BLOCK_POINTS
                if runtime.fft_allows(r, c, tile) and least:
                    out.append(tile)
    return out


def fft_kernel_sweep(torch) -> list[dict]:
    """The FFT kernel at ``FFT_SWEEP``'s grids on each of
    ``fft_configs``, each held to its plain version within the registry's
    atol, with its device time (profiler, both passes) beside the
    runtime's pick and ``torch.fft.fft2``'s."""
    from repro_torch.kernels import fft2d, runtime

    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = []
    for shape in FFT_SWEEP:
        picked = runtime.fft2d_route(*shape)
        re_, im_ = (torch.randn(shape, generator=gen, device="cuda")
                    for _ in range(2))
        times = {}
        for tile in fft_configs(shape):
            got = fft2d.fft2d(re_, im_, tiles=tile)
            err = max((g - w).abs().max().item() for g, w in zip(
                got, fft2d.fft_plain(re_, im_, tile)))
            if err > 1.0:
                fail(f"fft2d{shape} {tile}: max |err| {err}")
            del got
            times[tile] = device_ms(
                torch, lambda t=tile: fft2d.fft2d(re_, im_, tiles=t),
                "fft_pass_kernel", 10, launches=2)
        library = device_ms(
            torch, lambda: torch.fft.fft2(torch.complex(re_, im_)), None, 10)
        best = min((t for t in times if times[t]), key=times.get)
        rows.append(dict(shape=shape, picked=str(picked), best=str(best),
                         times={str(t): ms for t, ms in times.items()},
                         library=library))
        by = "; ".join(f"rows {t.rows} strip {t.strip} cluster {t.cluster}: "
                       f"{fmt_ms(ms)}" for t, ms in times.items())
        print(f"sweep fft2d{shape} FFT kernel: picked rows {picked.rows} "
              f"strip {picked.strip} cluster {picked.cluster} "
              f"{fmt_ms(times.get(picked))}, fastest rows {best.rows} strip "
              f"{best.strip} cluster {best.cluster} {fmt_ms(times[best])}; "
              f"torch.fft.fft2 {fmt_ms(library)}; device ms by "
              f"configuration: {by}", flush=True)
        del re_, im_
        torch.cuda.empty_cache()
    return rows


#: ``--conv2d-sweep``'s filters at 10240^2 outputs: float32 from 3 x 3 to
#: 32 x 32 (the generic window's filter in registers up to 8 x 8, in shared
#: memory above; 4 x 4 and 8 x 8 also on their compiled windows), and the
#: integers' compiled and generic cases
CONV2D_SWEEP = tuple(("float32", f) for f in (
    (3, 3), (4, 4), (5, 5), (7, 7), (8, 8), (12, 7), (16, 16), (32, 32))) + (
    ("int8", (8, 8)), ("int8", (3, 3)), ("int16", (5, 4)), ("int32", (3, 3)))


def fft_bench_timing(torch) -> dict:
    """fft2d_stage at its bench grid (the registry's two 8192^2 cases, both
    drawn as float32 planes) on the FFT kernel the runtime routes it to
    (``fft_pass_kernel``: a row pass and a column pass), held against the
    plain version (``fft2d.fft_plain`` on the card, bitwise) and the
    library call (``torch.fft.fft2`` on complex64, ``ref.fft2d``) within
    the registry's atol, and timed: the kernel's device time (profiler,
    both passes) and CUDA-event time, the plain version's, the library
    call's, the composition's (six float32 GEMMs on ``gemm_tc_kernel`` and
    their sums, the form before it: device time and CUDA events), and the
    bounds of the FFT form (four planes moved once; 5 N log2 N operations)
    and of the composition's DFT form (its six products at three TF32
    products a product, their operands and results moved once).  No DFT
    plane is built: past the twiddle tables of the first call, the card's
    allocation returns to its level."""
    from repro_torch.kernels import fft2d, ref, registry

    spec = registry.get("fft2d_stage")
    shape = spec.bench_cases[0][1]
    routed, composition, tile = fft_kernel(shape)
    gen = torch.Generator(device="cuda").manual_seed(24)
    re_, im_ = (torch.randn(shape, generator=gen, device="cuda")
                for _ in range(2))
    routed(re_, im_)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    before = dict(fft2d.variants)
    got = routed(re_, im_)
    torch.cuda.synchronize()
    forms = {v: fft2d.variants[v] - before[v] for v in before}
    left = torch.cuda.memory_allocated() - held - sum(
        g.nbytes for g in got)
    if left:
        fail(f"fft2d{shape}: {left} bytes left allocated by the call")
    plain = fft2d.fft_plain(re_, im_, tile)
    bitwise = all(torch.equal(g, w) for g, w in zip(got, plain))
    perr = max((g - w).abs().max().item() for g, w in zip(got, plain))
    del plain
    err = max((g - w).abs().max().item()
              for g, w in zip(got, ref.fft2d(re_, im_)))
    if err > spec.atol or perr > spec.atol \
            or forms != {"fused": 0, "fft": 1, "composition": 0}:
        fail(f"fft2d{shape} bench: max |err| {err} against torch.fft.fft2, "
             f"{perr} against the plain version (atol {spec.atol}), "
             f"transforms by form {forms}")
    del got
    torch.cuda.empty_cache()
    r, c = shape
    n = r * c
    row = dict(tiles=tile, max_abs_err=err, plain_max_abs_err=perr,
               bitwise=bitwise,
               ms=time_ms(torch, lambda: routed(re_, im_), reps=20),
               device_ms=device_ms(torch, lambda: routed(re_, im_),
                                   "fft_pass_kernel", 10, launches=2),
               plain_ms=time_ms(torch, lambda: fft2d.fft_plain(
                   re_, im_, tile), reps=3, warmup=1),
               library_ms=time_ms(torch, lambda: torch.fft.fft2(
                   torch.complex(re_, im_)), reps=20),
               library_device_ms=device_ms(torch, lambda: torch.fft.fft2(
                   torch.complex(re_, im_)), None, 10),
               composition_ms=time_ms(torch, lambda: composition(re_, im_),
                                      reps=3, warmup=1),
               composition_device_ms=device_ms(
                   torch, lambda: composition(re_, im_), None, 3),
               launches=1)
    row["bound_ms"], row["bound_by"] = least_ms(
        4 * n * 4, 5 * n * math.log2(n), "float32")
    row["dft_bound_ms"], row["dft_bound_by"] = least_ms(
        3 * (r * r + c * c + 4 * n) * 4, 3 * 3 * 2 * (r * r * c + r * c * c),
        "tfloat32")
    # the composition cannot beat its own DFT form's bound: a profiler
    # reading below it lost records, and the CUDA events stand
    if row["composition_device_ms"] is None \
            or row["composition_device_ms"] < row["dft_bound_ms"]:
        row["composition_device_ms"] = row["composition_ms"]
    print(f"time fft2d{shape} float32 planes [the bench cases, the FFT "
          f"kernel on {tile}, two passes]: {row['ms']:.4f} ms (device "
          f"{fmt_ms(row['device_ms'])}), library (torch.fft.fft2) "
          f"{row['library_ms']:.4f} ms (device "
          f"{fmt_ms(row['library_device_ms'])}), plain (fft2d.fft_plain) "
          f"{row['plain_ms']:.4f} ms, the composition (six 3xTF32 GEMMs) "
          f"{row['composition_ms']:.4f} ms (device "
          f"{fmt_ms(row['composition_device_ms'])}); bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}, FFT form) and "
          f"{row['dft_bound_ms']:.4f} ms ({row['dft_bound_by']}, the DFT "
          f"form in 3xTF32); max |err| {err:.4g} against torch.fft.fft2 "
          f"(atol {spec.atol}), {perr:.4g} against the plain version "
          f"(bitwise equal: {bitwise}); on "
          f"{torch.cuda.get_device_name(0)} [{nvidia_smi()}]", flush=True)
    del re_, im_
    torch.cuda.empty_cache()
    return row


def conv2d_sweep(torch) -> list[dict]:
    """conv2d at ``CONV2D_SWEEP``'s filters over 10240^2 outputs, each held
    to ``ref.conv2d``: profiler device time on the launch the runtime
    picks (``runtime.conv2d_tile``) and, where the checkout has one and it
    differs, on the generic window, beside ``F.conv2d`` (float32 copies,
    TF32 off) and the bound.  Uses only what every checkout of the port
    with a conv2d kernel has, so that ``--src`` can time an earlier
    checkout's kernel in the same run."""
    import torch.nn.functional as F

    from repro_torch.kernels import build, conv2d, planned, ref, runtime

    gen = torch.Generator(device="cuda").manual_seed(15)
    h, w = SP_BENCH["conv2d"][:2]
    rows = []
    for dname, (p, q) in CONV2D_SWEEP:
        dtype = getattr(torch, dname)
        args = (h, w, p, q)
        a, b = sp_operands(torch, gen, "conv2d", args, dtype)
        want = ref.conv2d(a, b)
        plan = planned.plan_for("conv2d", args, dname)
        launches = {"picked": runtime.conv2d_tile(plan, h, w).tile}
        if hasattr(runtime, "conv2d_config"):
            generic = runtime.conv2d_config(p, q, h, w,
                                            window=build.CONV2D_GENERIC)
            if generic != launches["picked"]:
                launches["generic"] = generic
        reps = 3 if p * q > 200 else 10
        row = dict(dtype=dname, filter=(p, q), bound_ms=sp_bound_ms(
            "conv2d", args, a.element_size(), 4, str(dtype))[0])
        for kind, tile in launches.items():
            err, ok = max_error(torch, conv2d.conv2d(a, b, tiles=tile), want,
                                dtype)
            if not ok:
                fail(f"conv2d{args} {dname} {tile}: max |err| {err}")
            row[kind] = str(tile)
            row[f"{kind}_device_ms"] = device_ms(
                torch, lambda t=tile: conv2d.conv2d(a, b, tiles=t),
                "conv2d_kernel", reps)
        af, bf = a.float(), b.float()
        row["library_device_ms"] = device_ms(
            torch, lambda: F.conv2d(af[None, None], bf[None, None]), None,
            reps)
        rows.append(row)
        print(f"sweep conv2d{args} {dname}: "
              + ", ".join(f"{k} {row[k]} {fmt_ms(row[k + '_device_ms'])}"
                          for k in launches)
              + f"; F.conv2d {fmt_ms(row['library_device_ms'])}; bound "
              f"{row['bound_ms']:.4f} ms", flush=True)
        del a, b, af, bf, want
        torch.cuda.empty_cache()
    return rows


#: ``--fir-sweep``'s cases: float32 at 2^20 to 2^26 outputs of 15 taps
#: (its compiled instantiation) and of 7, 64 and 255 (the generic one),
#: then the bench shape in int8 and int16 and the frontend's int16
FIR_SWEEP = tuple(("float32", 2 ** k, taps) for taps in (7, 15, 64, 255)
                  for k in range(20, 27)) + (
    ("int8", 2 ** 20, 15), ("int16", 2 ** 20, 15), ("int16", 6180, 15))


def fir_sweep(torch) -> list[dict]:
    """FIR at ``FIR_SWEEP``'s cases, each held to ``ref.fir``: profiler
    device time of the launch the runtime picks (``runtime.fir_tile``)
    beside ``F.conv1d`` (float32 copies, TF32 off), a ``copy_`` of the
    same bytes and the bound; 50 calls a time up to 2^21 outputs.  Uses
    only what every checkout of the port with a FIR kernel has, so that
    ``--src`` can time an earlier checkout's kernel in the same call."""
    import torch.nn.functional as F

    from repro_torch.kernels import fir, planned, ref, runtime

    gen = torch.Generator(device="cuda").manual_seed(20)
    rows = []
    for dname, n, taps in FIR_SWEEP:
        args, dtype = (n, taps), getattr(torch, dname)
        a, b = sp_operands(torch, gen, "fir", args, dtype)
        af, bf = a.float(), b.float()
        plan = planned.plan_for("fir", args, dname)
        tile = runtime.fir_tile(plan, n).tile
        out = fir.fir(a, b, tiles=tile)
        err, ok = max_error(torch, out, ref.fir(a, b), dtype)
        if not ok:
            fail(f"fir{args} {dname} {tile}: max |err| {err}")
        reps = 50 if n <= 2**21 else 3 if n * taps > 2**30 else 10
        row = dict(
            dtype=dname, n_out=n, taps=taps, tile=str(tile),
            max_abs_err=err,
            device_ms=device_ms(
                torch, lambda: fir.fir(a, b, tiles=tile), "fir_kernel",
                reps),
            library_device_ms=device_ms(
                torch, lambda: F.conv1d(af[None, None], bf[None, None]),
                None, reps),
            copy_device_ms=device_ms(torch, lambda: out.copy_(a[:n]),
                                     None, reps),
            bound_ms=sp_bound_ms("fir", args, a.element_size(), 4,
                                 str(dtype))[0])
        rows.append(row)
        print(f"sweep fir{args} {dname} {tile}: kernel "
              f"{fmt_ms(row['device_ms'])}, F.conv1d "
              f"{fmt_ms(row['library_device_ms'])}, copy_ "
              f"{fmt_ms(row['copy_device_ms'])}, bound "
              f"{row['bound_ms']:.4f} ms; max |err| {err:.4g}",
              flush=True)
        del a, b, af, bf, out
        torch.cuda.empty_cache()
    return rows


#: the prompt lengths ``--tc-sweep`` times
TC_SWEEP_PROMPTS = (512, 127, 64)


def tc_sweep(torch) -> list[dict]:
    """The tensor-core GEMM at every prefill shape of ``TC_SWEEP_PROMPTS``
    tokens (bf16; the scores flush to fp32, read K column-major; the
    values' A in padded rows) and quickstart's float32 1024^3, with every
    compiled tile of the dtype, split of K over 1-4 blocks (each rank a
    k-tile) and ring of 2 or 4 stages, each held to the plain version;
    profiler device time beside the runtime's pick and the library call
    (weight GEMMs over a rotation of ``COLD_BYTES``)."""
    from repro_torch.kernels import ref, runtime

    gen = torch.Generator(device="cuda").manual_seed(12)
    cases = [(site, kind, shape, col, "bfloat16")
             for p in TC_SWEEP_PROMPTS
             for site, kind, shape, col, _ in prefill_shapes(p)]
    cases.append(("quickstart", *QUICKSTART, False, "float32"))
    rows = []
    for site, kind, shape, col, dname in cases:
        dtype = getattr(torch, dname)
        out_dtype = torch.float32 if "scores" in site else None
        a, bs = rotation(torch, gen, kind, shape, col, dtype)
        if padded_site(site):
            a = padded(torch, a)
        fn, plain = gemm_fn(kind), ref.mm if kind == "mm" else ref.bmm
        want = plain(a, bs[0], out_dtype)
        picked = runtime.gemm_tile(a, bs[0], (64, 32, 32))
        ktiles = -(-shape[-1] * dtype.itemsize // runtime.TC_ROW_BYTES)
        times = {}
        for bm, bn in runtime.TC_TILES[dtype]:
            for split in range(1, runtime.TC_MAX_SPLIT + 1):
                if (split - 1) * -(-ktiles // split) >= ktiles:
                    continue
                for stages in (2, runtime.TC_MAX_STAGES):
                    tile = runtime.TcTile(bm, bn, stages, split)
                    err, ok = max_error(torch, fn(a, bs[0], tiles=tile,
                                                  out_dtype=out_dtype),
                                        want, want.dtype)
                    if not ok:
                        fail(f"{kind}{shape} {dname} {tile}: max |err| {err}")
                    times[tile] = device_ms(
                        torch, cycling(lambda x, y, t=tile: fn(
                            x, y, tiles=t, out_dtype=out_dtype), a, bs),
                        "gemm_tc_kernel", max(10, len(bs)))
        lib = torch.matmul if kind == "mm" else torch.bmm
        library = device_ms(torch, cycling(
            lambda x, y: lib(x, y) if out_dtype is None
            else lib(x, y, out_dtype), a, bs), None, max(10, len(bs)))
        best = min((t for t in times if times[t]), key=times.get)
        rows.append(dict(site=site, kind=kind, shape=shape, dtype=dname,
                         picked=str(picked), best=str(best),
                         times={str(t): ms for t, ms in times.items()},
                         library=library))
        by = ", ".join(f"{t.bm}x{t.bn}/{t.split}/{t.stages} "
                       f"{fmt_ms(ms).removesuffix(' ms')}"
                       for t, ms in times.items())
        print(f"sweep {kind}{shape} {dname} [{site}]: picked "
              f"{describe(picked, kind, shape)} {fmt_ms(times.get(picked))}, "
              f"fastest {describe(best, kind, shape)} {fmt_ms(times[best])}, "
              f"library {fmt_ms(library)}; device ms by tile/split/stages: "
              f"{by}", flush=True)
        del a, bs, want
    return rows


def recurrences_phase(torch) -> tuple[dict, dict, dict, dict]:
    """Phase 9 (module docstring): the launches of the pipeline run (all
    and the GEMMs' by kernel), the B6 / B7 time rows and the GEMM rows of
    the paper's MM/BMM table."""
    from repro_torch.launch import recurrences

    # the recurrence path: counts start at 0 here and are read right after
    reset_counts()
    t0 = time.perf_counter()
    rows = recurrences.run("cuda", "bench")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    variants = read_variants()
    if min(launches.values()) == 0:
        fail(f"a kernel was not launched on the recurrence path: {launches}")
    # every mttkrp case on the kernel its dtype and shape call for, and
    # each of its launches counted under that kernel
    cases = {}
    for row in rows:
        if row["name"] != "mttkrp":
            continue
        kernel = mttkrp_variant(row["tiles"].tile)
        if kernel != mttkrp_expected(row["args"], row["dtype"]):
            fail(f"recurrences: mttkrp {row['dtype']} ran on {kernel}")
        cases[row["dtype"]] = kernel
    by_kernel = variants["mttkrp"]
    if sum(by_kernel.values()) != launches["mttkrp"] or any(
            by_kernel[k] == 0 for k in set(cases.values())):
        fail(f"recurrences: mttkrp launches {launches['mttkrp']} by kernel "
             f"{by_kernel} do not match its cases {cases}")
    # every star and conv2d case on the launch the runtime chose for it
    # (one-sweep stars on star_kernel, jacobi2d_ms on sweeps_kernel in
    # ceil(T / T_b) launches of T_b >= 2, conv2d on its compiled window),
    # and each launch counted under that variant
    from repro_torch.kernels import build, registry, runtime
    calls = 1 + recurrences.TIMED_CALLS
    windows = {"jacobi2d": dict.fromkeys(variants["jacobi2d"], 0),
               "conv2d": dict.fromkeys(variants["conv2d"], 0)}
    chose = []
    for row in rows:
        tile = row["tiles"].tile if row["tiles"] else None
        name, rec = row["name"], row["rec"]
        if name in ("jacobi2d", "jacobi2d_9pt"):
            if not isinstance(tile, runtime.StarTile):
                fail(f"recurrences: {name} {row['dtype']} launched {tile}")
            windows["jacobi2d"]["star9" if name == "jacobi2d_9pt"
                                else "star5"] += calls
        elif name == "jacobi2d_ms":
            t = rec.extent("t")
            if not isinstance(tile, runtime.SweepTile) or (
                    t > 1 and tile.sweeps < 2):
                fail(f"recurrences: jacobi2d_ms {row['dtype']} launched "
                     f"{tile}")
            windows["jacobi2d"]["sweeps"] += calls * tile.launches(t)
        elif name == "conv2d":
            want = runtime.conv2d_window(rec.extent("p"), rec.extent("q"))
            if not isinstance(tile, runtime.Conv2dTile) \
                    or tile.window != want or want == build.CONV2D_GENERIC:
                fail(f"recurrences: conv2d {row['dtype']} launched {tile}")
            windows["conv2d"]["x".join(map(str, want))] += calls
        else:
            continue
        chose.append((name, row["dtype"], str(tile)))
    if any(variants[k] != v or launches[k] != sum(v.values())
           for k, v in windows.items()):
        fail(f"recurrences: star / conv2d launches by variant "
             f"{ {k: variants[k] for k in windows} }, the cases call for "
             f"{windows}")
    # fir's four bench cases (the cfloat one on float32 planes) on the
    # 15-tap instantiation, one launch a call
    firs = [row for row in rows if row["name"] == "fir"]
    want = len(firs) * calls
    if [r["dtype"] for r in firs] != [d for d, _ in registry.get(
            "fir").bench_cases] \
            or any(r["tiles"].tile.taps != 15 for r in firs) \
            or launches["fir"] != want or want != 16 \
            or variants["fir"] != {"15": want, "generic": 0}:
        fail(f"recurrences: fir cases {[(r['dtype'], r['args']) for r in firs]}"
             f" launched {launches['fir']} times (by instantiation "
             f"{variants['fir']}), the four bench cases call for 16 on the "
             f"15-tap one")
    # fft2d_stage's bench cases (two 8192^2 grids, above the fused kernel's
    # 64 rows) on the FFT kernel, each transform (two passes) counted
    # there, none on the composition.  The fused kernel is held by phase 3
    ffts = [row for row in rows if row["name"] == "fft2d_stage"]
    if [(r["dtype"], r["args"][:2]) for r in ffts] != list(
            registry.get("fft2d_stage").bench_cases) \
            or not all(isinstance(row["tiles"].tile, runtime.FftTile)
                       for row in ffts) \
            or variants["fft2d"] != {"fused": 0, "fft": len(ffts) * calls,
                                     "composition": 0} \
            or launches["fft2d"] != len(ffts) * calls:
        fail(f"recurrences: fft2d cases "
             f"{[(r['dtype'], r['args'], r['tiles'].tile) for r in ffts]}, "
             f"launches {launches['fft2d']} by form {variants['fft2d']}: "
             f"the bench cases call for {len(ffts) * calls} on the FFT "
             "kernel")
    # every mm / bmm (all above 16 rows: quickstart's, the smoke and the
    # paper's, float32 and the integers) on a tensor-core kernel, and each
    # launch of the two GEMM wrappers counted there
    gemms = [row for row in rows if row["name"] in ("mm", "bmm")]
    off = [(row["name"], row["dtype"], row["args"], row["tiles"].tile)
           for row in gemms
           if row["args"][-3] <= runtime.SKINNY_ROWS
           or not isinstance(row["tiles"].tile, runtime.TcTile)]
    kinds = {"widesa_mm": "mm", "bmm": "bmm"}
    miscounted = {name: variants[name] for name in kinds
                  if variants[name]["wgmma"] != launches[name]
                  or not any(r["name"] == kinds[name] for r in gemms)}
    if off or miscounted:
        fail(f"recurrences: GEMMs above 16 rows off the tensor-core kernels: "
             f"{off}; launches by kernel {miscounted} against {launches}")
    ints = sorted({(r["name"], r["dtype"], r["args"]) for r in gemms
                   if r["dtype"].startswith("int")})
    print(f"recurrences: {len(rows)} cases through lower_plan(plan, "
          f"'pallas') within tolerance in {dt:.1f} s; launches {launches}; "
          f"launches by kernel {variants} (GEMMs: every one of the "
          f"{len(gemms)} mm / bmm cases above 16 rows on the tensor cores, "
          f"gemm_tc_kernel in float32, gemm_tc_int_kernel in the integers "
          f"({len(ints)} cases: {ints}), no tiled launch; mttkrp cases "
          f"{cases}; fft2d "
          f"{[(r['dtype'], r['args'], r['max_abs_err']) for r in ffts]} on "
          f"the FFT kernel, each within the registry's atol "
          f"{registry.get('fft2d_stage').atol}"
          f"; star and conv2d cases on the runtime's launch, each counted "
          f"under its variant: {chose}; fir's bench cases "
          f"{[(r['dtype'], r['args'], str(r['tiles'].tile)) for r in firs]}"
          f", {want} launches on the 15-tap instantiation, cfloat{PLANES_NOTE}"
          f")", flush=True)
    torch.cuda.empty_cache()
    hpc_parity(torch)
    hpc_rows = hpc_timings(torch)
    gemm_rows = int_gemm_timings(torch)
    gemm_rows.update(float_paper_timings(torch))
    def below(dtype, other):
        row = hpc_rows[("mttkrp", dtype)]
        if None in (row["device_ms"], row.get(other)):
            return "not measured"
        return row["device_ms"] < row[other]

    dtypes = ("float32", "int8", "int16", "int32")
    print(f"recurrences: mttkrp device time below torch.einsum's: "
          f"{ {d: below(d, 'library_device_ms') for d in dtypes} }; below "
          f"the CUDA-core kernel's: "
          f"{ {d: below(d, 'cuda_core_device_ms') for d in dtypes} }",
          flush=True)
    return launches, variants, hpc_rows, gemm_rows


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# chip-level schedules on logical meshes (kernels/systolic.py)
# ---------------------------------------------------------------------------

#: the logical device count the systolic phase sets (``parallel.mesh``):
#: enough for its 2 x 4 meshes and the hierarchical outer 2 x inner 2 x 2
SYSTOLIC_DEVICES = 8
#: the meshes every spec's bench cases run on, and the specs the 2 x 4
#: chain / halo mesh adds (the Cannon rings need a square mesh)
SYSTOLIC_MESHES = ((1, 1), (2, 2))
SYSTOLIC_2X4 = ("conv2d", "fir", "jacobi2d_9pt")
#: the fused chains: (mesh, per-stage builder args, dtype, interstage)
SYSTOLIC_FUSED = (
    ((2, 2), (("mm", (8192, 8192, 8192)), ("mm", (8192, 8192, 8192))),
     "float32", ("bias_gelu",)),
    ((2, 2), (("mm", (4096, 4096, 4096)), ("mm", (4096, 4096, 4096))),
     "int16", None),
    ((2, 2), (("fft2d_stage", (8192, 8192)), ("fft2d_stage", (8192, 8192))),
     "cfloat", None),
    ((2, 4), (("conv2d", (10238, 10238, 4, 4)), ("jacobi2d", (10236, 10236))),
     "float32", None),
    ((2, 4), (("conv2d", (10238, 10238, 4, 4)), ("jacobi2d", (10236, 10236))),
     "int16", None),
)
#: the reference's hierarchical cases (outer 2 x 1 over inner 2 x 2,
#: int16), and mm / bmm at their float32 bench sizes
SYSTOLIC_HIER = (("mm", (128, 128, 128), "int16"),
                 ("bmm", (4, 128, 128, 64), "int16"),
                 ("jacobi2d", (128, 128), "int16"),
                 ("mm", (8192, 8192, 8192), "float32"),
                 ("bmm", (64, 4096, 4096, 4096), "float32"))
#: gelu's largest slope, which a difference of its input can grow by
GELU_LIPSCHITZ = 1.13
#: the kernel wrapper of each recurrence
SPEC_WRAPPER = {"mm": "widesa_mm", "bmm": "bmm", "fft2d_stage": "fft2d",
                "conv2d": "conv2d", "fir": "fir", "jacobi2d": "jacobi2d",
                "jacobi2d_9pt": "jacobi2d", "jacobi2d_ms": "jacobi2d",
                "mttkrp": "mttkrp"}


def schedule_launches(name, backend, shape, rec) -> dict:
    """The wrapper launches one call of ``name``'s ``backend`` schedule
    makes on a ``shape`` mesh: every member's compute on its hand kernel
    (a Cannon ring: n launches a member, four a step for fft2d's planes;
    a halo sweep one star launch a member; a broadcast baseline the whole
    problem on every member)."""
    from repro_torch.kernels import runtime

    members = shape[0] * shape[1]
    n = shape[0]
    wrapper = SPEC_WRAPPER[name]
    if name == "fft2d_stage":
        if backend == "systolic":
            return {"widesa_mm": 2 * 4 * n ** 3}
        # the fused or the FFT kernel launch no GEMM; the composition six
        routed = runtime.fft2d_route(rec.extent("i"), rec.extent("j"))
        return {"fft2d": members,
                **({} if routed else {"widesa_mm": 6 * members})}
    if backend == "systolic" and name in ("mm", "bmm", "mttkrp"):
        return {wrapper: n ** 3}
    if name == "jacobi2d_ms":
        sweeps = rec.extent("t")
        per = (sweeps if backend == "systolic"
               else runtime.sweep_tile(sweeps).launches(sweeps))
        return {wrapper: members * per}
    return {wrapper: members}


def schedule_bytes(name, backend, shape, rec, ops) -> int:
    """``parallel/collectives.py``'s model of the bytes ``name``'s
    ``backend`` schedule moves between members (``parallel.mesh.moved``):
    the Cannon rings' skews and rotations (both planes of fft2d's two
    stages, C and X of mttkrp), the halo strips of every sweep in the
    accumulator dtype, the chains' window tails, the all-gathers' shards;
    the broadcast baselines' operands are replicated by their specs and
    move nothing here."""
    from repro_torch.parallel import collectives as col

    n0, n1 = shape
    members = n0 * n1
    elem = ops[0].element_size()
    if backend == "allgather":
        if name in ("mm", "bmm"):
            a, b = ops
            a_blk = a.numel() * elem // members
            b_blk = b.numel() * elem // members
            return (n1 * col.ring_allgather_bytes(b_blk, n0)
                    + n0 * col.ring_allgather_bytes(a_blk, n1))
        if name == "mttkrp":
            x, _, c = ops
            return (n0 * col.ring_allgather_bytes(
                x.numel() * elem // members, n1)
                + n1 * col.ring_allgather_bytes(c.numel() * elem // members,
                                                n0))
        return 0
    if name in ("mm", "bmm"):
        a, b = ops
        return col.cannon_bytes(a.numel() * elem // members,
                                b.numel() * elem // members, n0)
    if name == "mttkrp":
        x, _, c = ops
        return col.cannon_bytes(x.numel() * elem // members,
                                c.numel() * elem // members, n0)
    if name == "fft2d_stage":
        plane = ops[0].numel() * 4 // members  # every plane is float32
        return 2 * col.cannon_bytes(2 * plane, 2 * plane, n0)
    if name == "conv2d":
        p = rec.extent("p")
        return col.chain_bytes((p - 1) * ops[0].shape[1] * elem, members)
    if name == "fir":
        return col.chain_bytes((rec.extent("t") - 1) * elem, members)
    # the stars: four radius-wide strips a sweep in the accumulator dtype
    r = 2 if name == "jacobi2d_9pt" else 1
    hl, wl = rec.extent("i") // n0, rec.extent("j") // n1
    sweeps = rec.extent("t") if name == "jacobi2d_ms" else 1
    return sweeps * (col.halo_exchange_bytes(r * wl * 4, (n0 - 1) * n1)
                     + col.halo_exchange_bytes(hl * r * 4, n0 * (n1 - 1)))


def systolic_operands(torch, gen, spec, rec):
    """A case's operands on the card: integers spanning their dtype's
    range (every product wraps), floats standard normal; the complex
    cases on their float32 planes, as the pipeline runs them."""
    dtype = getattr(torch, "float32" if rec.dtype.startswith("c")
                    else rec.dtype)
    return tuple(draw(torch, gen, shape, dtype)
                 for shape in spec.operand_shapes(rec))


def held_to(torch, got, want, bound) -> tuple[float, bool]:
    """(max |got - want|, within ``bound``: 0 for integers, a scalar or a
    per-output tensor for floats)."""
    gots = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    err, ok = 0.0, True
    for g, w in zip(gots, wants):
        if g.shape != w.shape or g.dtype != w.dtype:
            return float("inf"), False
        if not g.dtype.is_floating_point:
            e = int((g != w).sum().item())
            err, ok = max(err, float(e)), ok and e == 0
            continue
        diff = (g.double() - w.double()).abs()
        err = max(err, diff.max().item())
        ok = ok and bool((diff <= bound).all())
    return err, ok


class SystolicPaths:
    """Launches and launches by kernel, summed by path over the checked
    call of every schedule (each count set to 0 just before its call)."""

    def __init__(self):
        self.paths: dict[str, dict] = {}

    def add(self, path, counts, by_kernel):
        entry = self.paths.setdefault(path, {
            "launches": dict.fromkeys(wrappers(), 0),
            "variants": {name: dict.fromkeys(v, 0)
                         for name, v in read_variants().items()}})
        for name, n in counts.items():
            entry["launches"][name] += n
        for name, by in by_kernel.items():
            for key, n in by.items():
                entry["variants"][name][key] += n


def run_schedule(torch, label, fn, ops, want, bound, launches, model,
                 paths, path):
    """One schedule's checked call: counts and moved bytes set to 0 just
    before, read just after; launches and bytes against their models,
    the result against the flat hand-kernel path; then its CUDA-event
    time (members one after another on one card)."""
    from repro_torch.parallel import mesh as pm

    reset_counts()
    pm.moved_clear()
    got = fn(*ops)
    torch.cuda.synchronize()
    counts, by_kernel = read_counts(), read_variants()
    moved = sum(pm.moved.values())
    paths.add(path, counts, by_kernel)
    ran = {k: v for k, v in counts.items() if v}
    if ran != launches:
        fail(f"systolic {label}: launches {ran}, by kernel {by_kernel}, "
             f"the schedule makes {launches}")
    if moved != model:
        fail(f"systolic {label}: the collectives moved {moved} bytes "
             f"({dict(pm.moved)}), parallel/collectives.py models {model}")
    err, ok = held_to(torch, got, want, bound)
    if not ok:
        fail(f"systolic {label}: max |err| {err} against the flat hand-"
             "kernel path")
    del got
    ms = time_ms(torch, lambda: fn(*ops), reps=2, warmup=1)
    return {"launches": ran, "bytes": moved, "model_bytes": model,
            "max_abs_err": err, "ms": ms}


def systolic_flat(torch, spec, rec, ops):
    """The flat plan's hand kernel on one card (``lower_plan(plan,
    "pallas")``) and its CUDA-event time."""
    from repro_torch.core import Target, best_plan, lower_plan

    fn = lower_plan(best_plan(rec, Target(name="single_chip",
                                          mesh_shape=(1, 1))), "pallas")
    want = fn(*ops)
    torch.cuda.synchronize()
    return want, time_ms(torch, lambda: fn(*ops), reps=2, warmup=1)


def systolic_cases(torch, paths, gen) -> dict:
    """(a) every spec's ``systolic`` and ``allgather`` lowering at its
    bench cases on 1 x 1 and 2 x 2 (conv2d, fir and jacobi2d_9pt on 2 x 4
    too), each against the flat hand-kernel path on the same operands."""
    from repro_torch.core import Target, best_plan, lower_plan
    from repro_torch.kernels import registry
    from repro_torch.launch.recurrences import float_bound
    from repro_torch.parallel import mesh as pm

    rows = {}
    for spec in registry.specs():
        meshes = SYSTOLIC_MESHES + (((2, 4),) if spec.name in SYSTOLIC_2X4
                                    else ())
        for dname, args in spec.bench_cases:
            rec = spec.builder(*args, dname)
            ops = systolic_operands(torch, gen, spec, rec)
            want, flat_ms = systolic_flat(torch, spec, rec, ops)
            bound = (0.0 if dname.startswith("int")
                     else float_bound(spec, rec, ops))
            case = f"{spec.name}{tuple(args)} {dname}"
            row = {"flat_ms": flat_ms}
            for shape in meshes:
                target = Target(name="chip", mesh_shape=shape)
                plan = best_plan(rec, target)
                mesh = pm.make_mesh(shape, target.mesh_axes)
                tag = f"{shape[0]}x{shape[1]}"
                for backend in ("systolic", "allgather"):
                    fn = lower_plan(plan, backend, mesh=mesh)
                    row[f"{backend} {tag}"] = run_schedule(
                        torch, f"{case} {backend} {tag}", fn, ops, want,
                        bound, schedule_launches(spec.name, backend, shape,
                                                 rec),
                        schedule_bytes(spec.name, backend, shape, rec, ops),
                        paths, f"systolic_{tag}")
            rows[case] = row
            del ops, want, bound
            torch.cuda.empty_cache()
    return rows


def fused_models(plan, shape, ops) -> tuple[dict, int]:
    """The launches and the modelled bytes of one call of a fused chain's
    schedule on a ``shape`` mesh: each mm ring's skew and rotations (its
    left operand the last stage's output at the accumulator's output
    dtype), both planes of both fft rings, the deep halo's east and south
    strips; every member runs each stage on its hand kernel."""
    from repro_torch.core import fusion
    from repro_torch.parallel import collectives as col

    n = shape[0]
    members = shape[0] * shape[1]
    stages = plan.chain.stages
    elem = ops[0].element_size()
    if plan.family == "cannon":
        stage_ops, _ = fusion.split_operands(plan, ops)
        rows, a_elem, model = stage_ops[0][0].shape[0], elem, 0
        k = stage_ops[0][0].shape[1]
        for i, sops in enumerate(stage_ops):
            w = sops[1] if i == 0 else sops[0]
            model += col.cannon_bytes(rows * k * a_elem // members,
                                      w.numel() * elem // members, n)
            k, a_elem = w.shape[1], 4 if not ops[0].is_floating_point() \
                else elem
        return {"widesa_mm": len(stages) * n ** 3}, model
    if plan.family == "fft":
        plane = ops[0].numel() * 4 // members
        return ({"widesa_mm": 2 * 4 * n ** 3},
                2 * col.cannon_bytes(2 * plane, 2 * plane, n))
    s_h, s_w = fusion.halo_shrink(plan.chain)
    bh = (ops[0].shape[0] - s_h) // shape[0]
    bw = (ops[0].shape[1] - s_w) // shape[1]
    model = ((shape[1] - 1) * shape[0] * bh * s_w
             + (shape[0] - 1) * shape[1] * s_h * (bw + s_w)) * elem
    return ({k: members * v for k, v in Counter(
        SPEC_WRAPPER[s.name] for s in stages).items()}, model)


def systolic_fused(torch, paths, gen) -> dict:
    """(b) ``lower_fused(plan, "fused_systolic")`` of each
    ``SYSTOLIC_FUSED`` chain against the flat ``pallas`` composition: ints
    bitwise, fft2d within its atol, the other float chains within the last
    stage's ``float_bound`` on the composition's intermediate plus the
    first stage's largest bound carried through the last stage's weights
    (times gelu's largest slope)."""
    from repro_torch.core import Target, fusion
    from repro_torch.kernels import registry
    from repro_torch.launch.recurrences import float_bound
    from repro_torch.parallel import mesh as pm

    rows = {}
    for shape, stages, dname, inter in SYSTOLIC_FUSED:
        chain = fusion.chain(*(registry.get(n).builder(*a, dname)
                               for n, a in stages))
        target = Target(name="chip", mesh_shape=shape)
        plan = fusion.fuse(chain, target, interstage=inter)
        mesh = pm.make_mesh(shape, target.mesh_axes)
        run_chain = (chain if not dname.startswith("c")
                     else chain.with_dtype("float32"))
        ops = fusion.chain_operands(run_chain, gen, interstage=inter,
                                    device=gen.device)
        if dname.startswith("int"):
            ops = tuple(draw(torch, gen, o.shape, o.dtype) for o in ops)
        reset_counts()
        pallas = fusion.lower_fused(plan, "pallas")
        want = pallas(*ops)
        torch.cuda.synchronize()
        flat_ms = time_ms(torch, lambda: pallas(*ops), reps=2, warmup=1)
        last = registry.get(chain.stages[-1].name)
        if dname.startswith("int"):
            bound = 0.0
        elif last.n_outputs > 1:
            bound = last.atol
        else:
            first = registry.get(chain.stages[0].name)
            stage_ops, biases = fusion.split_operands(plan, ops)
            mid = registry.get(chain.stages[0].name).ref(*stage_ops[0])
            b1 = float_bound(first, chain.stages[0], stage_ops[0])
            mid = fusion.interstage_apply(inter[0] if inter else None, mid,
                                          biases[0])
            weights = stage_ops[1][0].abs().double()
            carry = (weights.sum(dim=0) if last.name == "mm"
                     else weights.sum())
            slope = GELU_LIPSCHITZ if inter and "gelu" in inter[0] else 1.0
            bound = (float_bound(last, chain.stages[-1], (mid,
                                                          *stage_ops[1]))
                     + float(b1.max()) * slope * carry.float())
            del mid, weights, carry, b1
        fn = fusion.lower_fused(plan, "fused_systolic", mesh=mesh)
        launches, model = fused_models(plan, shape, ops)
        label = f"{chain.name}{tuple(a for _, a in stages)} {dname}" + (
            f" {inter[0]}" if inter else "")
        row = run_schedule(torch, label, fn, ops, want, bound, launches,
                           model, paths, "systolic_fused")
        row["flat_ms"] = flat_ms
        row["mesh"] = f"{shape[0]}x{shape[1]}"
        rows[label] = row
        del ops, want, bound
        torch.cuda.empty_cache()
    return rows


def systolic_hier(torch, paths, gen) -> dict:
    """(c) ``lower_hierarchical(plan, backend)`` of each
    ``SYSTOLIC_HIER`` case at outer 2 x 1 over inner 2 x 2 (each group
    a 2 x 2 mesh of its own four logical devices), against the flat
    hand-kernel path: ints bitwise, floats within ``float_bound``."""
    from repro_torch.core import HierarchicalTarget, Target, best_plan
    from repro_torch.core import hierarchy
    from repro_torch.kernels import registry
    from repro_torch.launch.recurrences import float_bound

    inner = Target(name="hier_inner", mesh_shape=(2, 2),
                   mesh_axes=("row", "col"))
    ht = HierarchicalTarget(name="hier", outer_shape=(2, 1), inner=inner)
    rows = {}
    for name, args, dname in SYSTOLIC_HIER:
        spec = registry.get(name)
        rec = spec.builder(*args, dname)
        plan = best_plan(rec, ht)
        if not isinstance(plan, hierarchy.HierarchicalPlan):
            fail(f"systolic hier {name}{args}: no two-level plan ({plan})")
        ops = systolic_operands(torch, gen, spec, rec)
        want, flat_ms = systolic_flat(torch, spec, rec, ops)
        bound = (0.0 if dname.startswith("int")
                 else float_bound(spec, rec, ops))
        sub = plan.sub_recurrence
        meta = tuple(torch.empty(s, dtype=ops[0].dtype, device="meta")
                     for s in spec.operand_shapes(sub))
        g = ht.groups
        label = f"{name}{tuple(args)} {dname} split={plan.outer_split}"
        row = {"flat_ms": flat_ms, "split": plan.outer_split,
               "sub_shape": list(sub.extents)}
        for backend in ("systolic", "allgather"):
            fn = hierarchy.lower_hierarchical(plan, backend)
            launches = {k: g * v for k, v in schedule_launches(
                name, backend, (2, 2), sub).items()}
            model = g * schedule_bytes(name, backend, (2, 2), sub, meta)
            row[backend] = run_schedule(
                torch, f"{label} {backend}", fn, ops, want, bound,
                launches, model, paths, "systolic_hier")
        rows[label] = row
        del ops, want, bound
        torch.cuda.empty_cache()
    return rows


def systolic_phase(torch, device_name: str) -> dict:
    """Phase 10c: the chip-level schedules (``kernels/systolic.py``) on
    logical meshes of one card (``parallel.mesh``, ``SYSTOLIC_DEVICES``
    logical devices, all this card): (a) ``systolic_cases``, (b)
    ``systolic_fused``, (c) ``systolic_hier``.  Every member computes on
    its hand kernel, one after another, so each time is the members'
    work serialized on one card with no interconnect, not a speed
    figure.  Returns each path's launches and launches by kernel and
    every row."""
    from repro_torch.parallel import mesh as pm

    t0 = time.perf_counter()
    paths = SystolicPaths()
    gen = torch.Generator(device="cuda").manual_seed(30)
    with pm.logical_devices(SYSTOLIC_DEVICES):
        if pm.devices() != [torch.device("cuda", i % torch.cuda.device_count())
                            for i in range(SYSTOLIC_DEVICES)]:
            fail(f"systolic: logical devices {pm.devices()}")
        rows = systolic_cases(torch, paths, gen)
        fused = systolic_fused(torch, paths, gen)
        hier = systolic_hier(torch, paths, gen)

    def show(label, r):
        return (f"{label}: {r['launches']} launches, {r['bytes']} bytes "
                f"(model {r['model_bytes']}), {r['ms']:.4f} ms, max |err| "
                f"{r['max_abs_err']:.3g}")

    for case, row in rows.items():
        print(f"systolic {case}: flat {row['flat_ms']:.4f} ms; " + "; ".join(
            show(key, r) for key, r in row.items() if key != "flat_ms"),
            flush=True)
    for label, r in fused.items():
        print(f"systolic fused {label} on {r['mesh']}: flat pallas "
              f"composition {r['flat_ms']:.4f} ms; {show('fused_systolic', r)}",
              flush=True)
    for label, row in hier.items():
        print(f"systolic hier {label} -> {tuple(row['sub_shape'])} a group "
              f"(outer 2 x inner 2x2): flat {row['flat_ms']:.4f} ms; "
              + "; ".join(show(b, row[b]) for b in ("systolic", "allgather")),
              flush=True)
    print(f"systolic: {len(rows)} bench cases x (1x1, 2x2; 2x4 for "
          f"{', '.join(SYSTOLIC_2X4)}) x (systolic, allgather), "
          f"{len(fused)} fused chains, {len(hier)} two-level cases: every "
          "result equal to the flat hand-kernel path (ints bitwise, floats "
          "within float_bound), every member on its hand kernel, bytes "
          "equal to parallel/collectives.py's models; times are CUDA "
          "events of the members serialized on one card with no "
          f"interconnect; phase done in {time.perf_counter() - t0:.1f} s "
          f"on {device_name} [{nvidia_smi()}]", flush=True)
    return {"paths": paths.paths, "rows": rows, "fused": fused,
            "hier": hier}


# ---------------------------------------------------------------------------
# the mesh paths: MoE on EP and TP meshes, training on logical meshes, and
# the collectives, on logical meshes of one card
# ---------------------------------------------------------------------------

#: logical devices of the mesh phase (all this card)
MESH_DEVICES = 8
#: mesh_moe_ep: deepseek-v2-236b's layers on the card, its dense first
#: layer and 3 MoE layers, each of the shapes of the other 56 (``mesh_moe_ep``
#: prints the bytes); the prefill cell the reference's dry run lowers
MESH_EP_LAYERS = 4
MESH_EP_MESH = (1, 4)
#: both MoE paths' prompts: 4 x 512 tokens; mesh_moe_tp then 16 greedy steps
MESH_PROMPTS, MESH_PROMPT_LEN, MESH_DECODE_STEPS = 4, 512, 16
MESH_TP_MESH = (2, 2)
#: mesh_train: qwen's 8 x 512 a step on the 4 x 2 mesh of 8 logical
#: devices for 3 steps, then 2 on the 2 x 2 survivor mesh of 4
MESH_TRAIN_SHAPE = (512, 8)
MESH_TRAIN_STEPS = (3, 2)
#: olmoe under (2, 2): the float32 gradient parity at check (a)'s depth,
#: then 2 bf16 steps at the 10 layers olmoe_train runs, 4 x 512 a step
MESH_OLMOE_LAYERS, MESH_OLMOE_SHAPE, MESH_OLMOE_STEPS = 10, (512, 4), 2
#: the bf16 steps' losses on the mesh against one device's: the two runs
#: add the members' partial outputs in another order, each add one bf16
#: rounding, over 10 layers
MESH_LOSS_RTOL = 1e-2
#: mesh_collectives: the ring over 8 members at mm(8192, 8192, 1024) in
#: bf16 and float32, int8 at k = 10240 with operands in [120, 128) (every
#: output < 2^31, so a float64 product on the card is exact: the int64
#: oracle), quantized_psum of 8 x 2^20 floats, GPipe of qwen's 24 layers
RING_SHAPE, RING_INT8_SHAPE, RING_MEMBERS = (8192, 8192, 1024), \
    (2048, 2048, 10240), 8
QPSUM_ELEMS = 2 ** 20
PIPE_STAGES, PIPE_MICRO, PIPE_BATCH = 4, 4, 8
#: the GEMMs the mesh paths add, timed (``LONG_SHAPES``' layout): each
#: member's expert bmm under EP (deepseek at the config's capacity factor:
#: 40 local experts, C = 4 members x 24 rows) and under TP (olmoe with
#: nothing dropping: 32 local experts, C = 1024), and the ring's partial
#: (k = 1024 over 8 members, flushed to fp32)
MESH_SHAPES = (
    ("moe.gate/up, EP member (deepseek, 4 x 512 prefill)", "bmm",
     (40, 96, 1536, 5120), False, False, False, "bfloat16"),
    ("moe.down, EP member (deepseek, 4 x 512 prefill)", "bmm",
     (40, 96, 5120, 1536), False, False, False, "bfloat16"),
    ("moe.gate/up, TP member (olmoe, 4 x 512 prefill, nothing drops)",
     "bmm", (32, 1024, 1024, 2048), False, False, False, "bfloat16"),
    ("moe.down, TP member (olmoe, 4 x 512 prefill, nothing drops)", "bmm",
     (32, 1024, 2048, 1024), False, False, False, "bfloat16"),
    ("ring partial, bf16", "mm", (8192, 8192, 128), False, False, True,
     "bfloat16"),
    ("ring partial, float32", "mm", (8192, 8192, 128), False, False, False,
     "float32"),
)


def mesh_shape_launches(report) -> dict:
    """Each ``MESH_SHAPES`` GEMM's calls in a planned report, keyed (kind,
    shape, dtype)."""
    counts = count_shapes(report, [(k, shape) for _, k, shape, *_ in
                                   MESH_SHAPES])
    return {(k, shape, dname): counts[(k, shape)]
            for _, k, shape, *_, dname in MESH_SHAPES}


def counted_run(torch, fn):
    """``fn()`` with every wrapper's count set to 0 just before and read
    just after: (its result, launches, launches by kernel, the planned
    report's delta)."""
    from repro_torch.kernels import planned

    before = planned.planned_report()
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts(), read_variants(), planned.report_delta(
        before, planned.planned_report())


def moe_sites_planned(label, report, sites=("moe.gate", "moe.up",
                                            "moe.down")) -> None:
    bad = {s: report.get(s) for s in sites
           if not report.get(s, {}).get("planned")
           or report[s]["fallback"]}
    if bad:
        fail(f"{label}: member expert sites that did not plan: {bad}")


class RouteLog:
    """Every ``moe.route`` call's top-k ids and probabilities, copied to
    the host, while the block is active; with ``forced`` (ids a call, in
    call order) those ids replace the call's own, each weight
    renormalised from its own probabilities (``routing_explained``'s
    forcing)."""

    def __init__(self, forced=None):
        self.calls, self.forced = [], forced

    def __enter__(self):
        from repro_torch.models import moe

        self._route = route = moe.route

        def recording(cfg, logits):
            w, ids, probs = route(cfg, logits)
            if self.forced is not None:
                ids = self.forced[len(self.calls)].to(ids.device)
                w = probs.gather(-1, ids)
                w = w / w.sum(dim=-1, keepdim=True)
            self.calls.append((ids.cpu(), probs.cpu()))
            return w, ids, probs

        moe.route = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self._route


def mesh_rows(torch, shape, path, b, s) -> list:
    """For each member of a (data, model) mesh in row-major order, the
    global rows (``b * s`` flattened) its route call holds: TP, its batch
    block (None for a replica past the first on the model axis); EP, its
    batch block's slice of the sequence."""
    d_n, m_n = shape
    bl, sl = b // d_n, s // m_n
    rows = []
    for d in range(d_n):
        for m in range(m_n):
            if path == "tp":
                rows.append(None if m else torch.arange(d * bl * s,
                                                        (d + 1) * bl * s))
            else:
                lanes = torch.arange(d * bl, (d + 1) * bl)[:, None] * s
                rows.append((lanes + m * sl + torch.arange(sl)).reshape(-1))
    return rows


def global_routes(torch, calls, rows, b, s) -> list:
    """The mesh path's route calls (a layer's members in turn) as one
    [b * s, k] id tensor a layer, in the single-device path's row
    order."""
    per = len(rows)
    out = []
    for i in range(0, len(calls), per):
        ids = torch.empty((b * s, calls[i][0].shape[1]), dtype=torch.int64)
        for (got, _), r in zip(calls[i:i + per], rows):
            if r is not None:
                ids[r] = got
        out.append(ids)
    return out


def route_flips(mesh_ids, single_calls) -> list:
    """(layer, row, expert, gap) of every expert the mesh path chose and
    the single-device path did not, with the gap by which its probability
    on the single path misses that path's k-th."""
    flips = []
    for layer, (ids, (pids, probs)) in enumerate(zip(mesh_ids,
                                                     single_calls)):
        kth = probs.gather(-1, pids).min(-1).values
        differ = (ids.sort(-1).values != pids.sort(-1).values).any(-1)
        for row in differ.nonzero().flatten().tolist():
            for ex in sorted(set(ids[row].tolist()) - set(pids[row].tolist())):
                flips.append((layer, row, ex,
                              round(float(kth[row] - probs[row, ex]), 7)))
    return flips


def first_flips_near_ties(flips) -> bool:
    first = [f for f in flips if f[0] == flips[0][0]] if flips else []
    return bool(first) and max(f[3] for f in first) <= ROUTER_ATOL


def mesh_explained(torch, label, single_fn, mesh_calls, single_calls, rows,
                   b, s, mesh_logits) -> None:
    """A mesh path's prefill logits past ``LOGIT_ATOL`` from one device's
    pass only where routing explains the miss, as ``routing_explained``
    has it: the first layer with a flip flips near-ties only (gaps within
    ``ROUTER_ATOL``), and one device with the mesh path's routing forced
    gives the mesh path's logits within ``LOGIT_ATOL``."""
    mesh_ids = global_routes(torch, mesh_calls, rows, b, s)
    flips = route_flips(mesh_ids, single_calls)
    with RouteLog(forced=mesh_ids):
        forced = single_fn()
    err = (forced.float() - mesh_logits.float()).abs().max().item()
    ok = first_flips_near_ties(flips) and err <= LOGIT_ATOL
    print(f"{label}: {len(flips)} routing flips against one device (layer, "
          f"row, expert, gap) {flips[:12]}{' ...' if len(flips) > 12 else ''}"
          f"; the first layer's near-ties within {ROUTER_ATOL}: "
          f"{first_flips_near_ties(flips)}; one device with the mesh's "
          f"routing forced is {err:.4f} from the mesh's logits", flush=True)
    if not ok:
        fail(f"{label}: the logits' miss is not explained by near-tie "
             "routing flips")


def mesh_moe_ep(torch, device_name: str) -> dict:
    """``mesh_moe_ep``: deepseek-v2-236b at its published width cut to
    ``MESH_EP_LAYERS`` layers, under ``mesh_context`` of a (1, 4) mesh
    with its config's ``moe_ep``: ``api.prefill`` of 4 x 512 tokens
    through ``moe_ep_alltoall`` (the counted path), every member's expert
    stack on the hand kernels; held at the config's capacity factor to
    the same mesh path on the plain versions, and with nothing dropping
    (capacity factor E / k) to one device's prefill of the same weights
    on the kernels, each within ``LOGIT_ATOL`` or explained by near-tie
    routing."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import planned
    from repro_torch.models import build_model
    from repro_torch.parallel import mesh as pm
    from repro_torch.parallel.collectives import ring_allreduce_bytes
    from repro_torch.parallel.sharding import mesh_context

    t_phase = time.perf_counter()
    full = get_config(DEEPSEEK_ARCH)
    cfg = dataclasses.replace(full, n_layers=MESH_EP_LAYERS)
    if not cfg.moe_ep:
        fail(f"mesh_moe_ep: {DEEPSEEK_ARCH}'s config has moe_ep off")
    api = build_model(cfg, "cuda")
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    weights = sum(t.numel() * t.element_size() for t in iter_tensors(params))
    experts = sum(params["layers"][1]["moe"][k].numel() * 2
                  for k in ("wg", "wu", "wd"))
    mesh = pm.make_mesh(MESH_EP_MESH, ("data", "model"))
    b, s = MESH_PROMPTS, MESH_PROMPT_LEN
    tokens = np.random.default_rng(31).integers(0, cfg.vocab, (b, s))
    batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int32,
                                       device="cuda")}
    print(f"mesh_moe_ep: {DEEPSEEK_ARCH} at its published width cut to "
          f"{cfg.n_layers} of {full.n_layers} layers (the dense first "
          f"layer and {cfg.n_layers - 1} MoE layers of the other 56's "
          f"shapes): {gib(weights)} of weights; each prefill shards every "
          f"MoE layer's experts onto the members, {experts / 1e9:.2f} GB of "
          f"copies a layer ({cfg.moe_num_experts // MESH_EP_MESH[1]} "
          f"experts a member), freed after the layer; mesh "
          f"{MESH_EP_MESH} ('data', 'model'), moe_ep {cfg.moe_ep}, "
          f"capacity factor {cfg.moe_capacity_factor}", flush=True)

    def prefill(api_, mesh_=None):
        ctx = mesh_context(mesh_) if mesh_ is not None \
            else contextlib.nullcontext()
        with torch.no_grad(), ctx:
            return api_.prefill(params, batch, s)[0]

    pm.moved_clear()
    t0 = time.perf_counter()
    logits, launches, variants, report = counted_run(
        torch, lambda: prefill(api, mesh))
    t_mesh = time.perf_counter() - t0
    moved = dict(pm.moved)
    moe_sites_planned("mesh_moe_ep", report)
    shapes = mesh_shape_launches(report)
    if not launches["bmm"] or not launches["widesa_mm"] \
            or not torch.isfinite(logits).all() \
            or logits.shape != (b, cfg.vocab):
        fail(f"mesh_moe_ep: launches {launches}, variants {variants}, "
             f"logits {tuple(logits.shape)}")
    with planned.override(enabled=False):
        plain = prefill(api, mesh)
    err = (logits.float() - plain.float()).abs().max().item()
    print(f"mesh_moe_ep: EP prefill of {b} x {s} tokens on the kernels "
          f"({launches['bmm']} bmm and {launches['widesa_mm']} mm launches, "
          f"{variants['bmm']}; moe.gate/up/down planned on every member) "
          f"against the same mesh path on the plain versions: max |diff| "
          f"{err:.4f} (bound {LOGIT_ATOL})", flush=True)
    if err > LOGIT_ATOL:
        with mesh_context(mesh):
            ok, why = routing_explained(torch, api, params, batch, s, logits)
        print(f"mesh_moe_ep: {why}", flush=True)
        if not ok:
            fail("mesh_moe_ep: the kernels' miss of the plain versions is "
                 "not explained by near-tie routing")
    del plain
    cfg_nd = dataclasses.replace(
        cfg, moe_capacity_factor=cfg.moe_num_experts / cfg.moe_top_k)
    api_nd = build_model(cfg_nd, "cuda")
    t0 = time.perf_counter()
    with RouteLog() as one_log:
        single = prefill(api_nd)
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t0
    t0 = time.perf_counter()
    with RouteLog() as mesh_log:
        mesh_nd = prefill(api_nd, mesh)
    torch.cuda.synchronize()
    t_mesh_nd = time.perf_counter() - t0
    err = (single.float() - mesh_nd.float()).abs().max().item()
    print(f"mesh_moe_ep: nothing dropping (capacity factor "
          f"{cfg_nd.moe_capacity_factor:.3f}), the EP prefill against one "
          f"device's prefill of the same weights on the kernels: max |diff| "
          f"{err:.4f} (bound {LOGIT_ATOL})", flush=True)
    if err > LOGIT_ATOL:
        mesh_explained(torch, "mesh_moe_ep", lambda: prefill(api_nd),
                       mesh_log.calls, one_log.calls,
                       mesh_rows(torch, MESH_EP_MESH, "ep", b, s), b, s,
                       mesh_nd)
    del single, mesh_nd, one_log, mesh_log
    payload = b * s * cfg.d_model * 2
    print(f"mesh_moe_ep: on the host clock the counted EP prefill took "
          f"{t_mesh:.2f} s; nothing dropping, the EP prefill {t_mesh_nd:.2f} "
          f"s against one device's {t_single:.2f} s (route logging on in "
          f"both): the members' work serialized on one card plus their "
          f"device-to-device copies, not a speed; moved {moved} "
          f"(all_to_all: dispatched rows out and back; a ring all-reduce "
          f"of one layer's activations would move "
          f"{ring_allreduce_bytes(payload, MESH_EP_MESH[1])}); phase "
          f"{time.perf_counter() - t_phase:.1f} s on {device_name} "
          f"[{nvidia_smi()}]", flush=True)
    del params
    torch.cuda.empty_cache()
    return {"launches": launches, "variants": variants, "moved": moved,
            "shapes": shapes, "seconds": t_mesh, "nd_seconds": t_mesh_nd,
            "single_seconds": t_single}


def mesh_moe_tp(torch, device_name: str) -> dict:
    """``mesh_moe_tp``: olmoe-1b-7b at full width and depth with nothing
    dropping (capacity factor E / k) under a (2, 2) mesh through
    ``_moe_shard_map`` (the counted path): ``api.prefill`` of 4 x 512
    tokens and ``MESH_DECODE_STEPS`` ``api.decode`` steps fed one
    device's greedy tokens, against one device's prefill and greedy
    steps: every step's logits within ``LOGIT_ATOL`` (the prefill's miss
    explained by near-tie routing where past it; a step's by a near-tie
    flip in it or before it) and its argmax the single path's token where
    that token's lead is wider than the step's difference."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.parallel import mesh as pm
    from repro_torch.parallel.collectives import ring_allreduce_bytes
    from repro_torch.parallel.sharding import mesh_context

    t_phase = time.perf_counter()
    base = get_config(MOE_ARCH)
    cfg = dataclasses.replace(
        base, moe_capacity_factor=base.moe_num_experts / base.moe_top_k)
    api = build_model(cfg, "cuda")
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    mesh = pm.make_mesh(MESH_TP_MESH, ("data", "model"))
    b, s, n = MESH_PROMPTS, MESH_PROMPT_LEN, MESH_DECODE_STEPS
    max_seq = s + n
    tokens = np.random.default_rng(32).integers(0, cfg.vocab, (b, s))
    batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int32,
                                       device="cuda")}

    def drive(feed=None, mesh_=None):
        """Prefill and ``n`` decode steps: greedy, or fed ``feed``'s
        tokens; (prefill logits, step logits, step tokens, route logs:
        the prefill's and each step's)."""
        ctx = mesh_context(mesh_) if mesh_ is not None \
            else contextlib.nullcontext()
        logs, steps, fed = [RouteLog()], [], []
        with torch.no_grad(), ctx:
            with logs[0]:
                first, cache = api.prefill(params, batch, max_seq)
            nxt = first.argmax(-1).to(torch.int32)
            for i in range(n):
                tok = nxt if feed is None else feed[i]
                fed.append(tok)
                logs.append(RouteLog())
                with logs[-1]:
                    out, cache = api.decode(params, cache, tok[:, None])
                steps.append(out.reshape(b, -1))
                nxt = steps[-1].argmax(-1).to(torch.int32)
        return first, steps, fed, logs

    t0 = time.perf_counter()
    first_1, steps_1, fed_1, logs_1 = drive()
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t0
    pm.moved_clear()
    t0 = time.perf_counter()
    (first_m, steps_m, _, logs_m), launches, variants, report = counted_run(
        torch, lambda: drive(fed_1, mesh))
    t_mesh = time.perf_counter() - t0
    moved = dict(pm.moved)
    moe_sites_planned("mesh_moe_tp", report)
    shapes = mesh_shape_launches(report)
    if not launches["bmm"] or not launches["widesa_mm"]:
        fail(f"mesh_moe_tp: launches {launches}, variants {variants}")
    err = (first_1.float() - first_m.float()).abs().max().item()
    print(f"mesh_moe_tp: {MOE_ARCH} at full width ({cfg.n_layers} layers, "
          f"{cfg.moe_num_experts} experts, top-{cfg.moe_top_k}) on a "
          f"{MESH_TP_MESH} mesh through the TP path, nothing dropping "
          f"(capacity factor {cfg.moe_capacity_factor}): prefill of {b} x "
          f"{s} tokens against one device's, max |diff| {err:.4f} (bound "
          f"{LOGIT_ATOL})", flush=True)
    if err > LOGIT_ATOL:
        mesh_explained(torch, "mesh_moe_tp", lambda: api.prefill(
            params, batch, max_seq)[0], logs_m[0].calls, logs_1[0].calls,
            mesh_rows(torch, MESH_TP_MESH, "tp", b, s), b, s, first_m)
    flipped, worst, agree, ties = False, 0.0, 0, []
    rows = mesh_rows(torch, MESH_TP_MESH, "tp", b, 1)
    for i in range(n):
        flips = route_flips(global_routes(torch, logs_m[i + 1].calls, rows,
                                          b, 1), logs_1[i + 1].calls)
        flipped = flipped or first_flips_near_ties(flips)
        diff = (steps_1[i].float() - steps_m[i].float()).abs().max().item()
        worst = max(worst, diff)
        if diff > LOGIT_ATOL and not flipped:
            fail(f"mesh_moe_tp: decode step {i} logits differ by {diff} > "
                 f"{LOGIT_ATOL} with no near-tie routing flip before")
        want = fed_1[i + 1] if i + 1 < n else steps_1[i].argmax(-1)
        got = steps_m[i].argmax(-1)
        top2 = steps_1[i].float().topk(2, dim=-1).values
        for lane in range(b):
            if int(got[lane]) == int(want[lane]):
                agree += 1
            elif float(top2[lane, 0] - top2[lane, 1]) <= diff or flipped:
                ties.append((i, lane))
            else:
                fail(f"mesh_moe_tp: step {i} lane {lane}: the mesh's token "
                     f"{int(got[lane])} is not one device's "
                     f"{int(want[lane])} and no near-tie explains it")
    payload = b * s * cfg.d_model * 2
    print(f"mesh_moe_tp: {n} decode steps fed one device's greedy tokens: "
          f"logits max |diff| {worst:.4f}, {agree} of {b * n} tokens equal"
          + (f", {ties} near-ties" if ties else "") + f"; {launches['bmm']} "
          f"bmm and {launches['widesa_mm']} mm launches ({variants['bmm']}, "
          f"{variants['widesa_mm']}), every member's moe.gate/up/down "
          f"planned; {t_mesh:.2f} s on the host clock against one device's "
          f"{t_single:.2f} s (the members' work serialized, every layer's "
          f"expert blocks copied onto its members, not a speed); moved "
          f"{moved} (psum: each layer's partial outputs; a ring all-reduce "
          f"of one prefill layer's {payload} bytes over the 2-wide expert "
          f"axis would move {ring_allreduce_bytes(payload, 2)}); phase "
          f"{time.perf_counter() - t_phase:.1f} s on {device_name} "
          f"[{nvidia_smi()}]", flush=True)
    del params
    torch.cuda.empty_cache()
    return {"launches": launches, "variants": variants, "moved": moved,
            "shapes": shapes, "seconds": t_mesh, "single_seconds": t_single}


def mesh_train(torch, device_name: str) -> dict:
    """``mesh_train``: (1) qwen1.5-0.5b at full width, ``MESH_TRAIN_SHAPE``
    tokens a step: ``Trainer(mesh=make_mesh_from_devices(devices()[:8],
    model_parallel=2))`` takes 3 steps and checkpoints, a ``Trainer`` on
    the 2 x 2 survivor mesh of 4 resumes and takes 2 (the counted path);
    the same on one device gives the same losses bit for bit (no MoE
    block, so the mesh changes nothing qwen computes).  (2) olmoe-1b-7b
    under (2, 2) with nothing dropping: the float32 gradients at check
    (a)'s depth of the loss without its load-balance term (a mesh's is
    each shard's own, as the reference's), every expert weight's within
    ``GRAD_RTOL`` (relative L2) of one device's with the mesh's routing
    forced there (without, a miss
    passes only through near-tie routing flips: the members' router
    products sum in another order), then ``MESH_OLMOE_STEPS`` bf16 train
    steps at
    ``MESH_OLMOE_LAYERS`` layers, each loss within ``MESH_LOSS_RTOL`` of
    one device's."""
    import dataclasses
    import tempfile

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import SyntheticPipeline
    from repro_torch.launch.mesh import make_mesh_from_devices
    from repro_torch.models import build_model
    from repro_torch.models import transformer as TFM
    from repro_torch.parallel import mesh as pm
    from repro_torch.parallel.sharding import mesh_context
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.loop import batch_tensors
    from repro_torch.train.step import value_and_grad

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(ARCH), grad_accum=1)
    shape = ShapeSpec("mesh_train", "train", *MESH_TRAIN_SHAPE)
    tc = TrainConfig(total_steps=sum(MESH_TRAIN_STEPS), ckpt_every=100,
                     log_every=100)
    devs = pm.devices()
    meshes = (make_mesh_from_devices(devs[:8], model_parallel=2),
              make_mesh_from_devices(devs[:4], model_parallel=2))

    def elastic(ckpt, mesh_pair):
        hist = []
        for mesh, steps, resume in zip(mesh_pair, MESH_TRAIN_STEPS,
                                       (False, True)):
            t = Trainer(cfg, shape, ckpt_dir=ckpt, tcfg=tc, mesh=mesh)
            hist += t.run(steps, resume=resume)[2]
            del t
        return hist

    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        t0 = time.perf_counter()
        hist, launches, variants, _ = counted_run(
            torch, lambda: elastic(d1, meshes))
        t_mesh = time.perf_counter() - t0
        single = elastic(d2, (None, None))
    if hist != single or not all(math.isfinite(x) for x in hist):
        fail(f"mesh_train: the elastic run's losses {hist} are not one "
             f"device's {single}")
    if not launches["widesa_mm"] or not launches["bmm"]:
        fail(f"mesh_train: launches {launches}, variants {variants}")
    print(f"mesh_train: {ARCH} at full width, {shape.global_batch} x "
          f"{shape.seq_len} a step: {MESH_TRAIN_STEPS[0]} steps on "
          f"{meshes[0].shape}, a checkpoint, {MESH_TRAIN_STEPS[1]} resumed "
          f"on the survivors' {meshes[1].shape}: losses {hist}, bit for bit "
          f"one device's; {launches['widesa_mm']} mm and {launches['bmm']} "
          f"bmm launches ({variants['widesa_mm']}); {t_mesh:.2f} s on the "
          f"host clock", flush=True)
    torch.cuda.empty_cache()
    # (2) olmoe: float32 gradients at check (a)'s depth, nothing dropping
    base = get_config(MOE_ARCH)
    nd = base.moe_num_experts / base.moe_top_k
    cfg32 = dataclasses.replace(base, dtype="float32", grad_accum=1,
                                n_layers=MOE_PARITY_LAYERS, remat="none",
                                moe_capacity_factor=nd)
    api = build_model(cfg32, "cuda")
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    oshape = ShapeSpec("mesh_olmoe", "train", *MESH_OLMOE_SHAPE)
    batch = batch_tensors(SyntheticPipeline(cfg32, oshape).batch(0), "cuda")
    mesh = pm.make_mesh(MESH_TP_MESH, ("data", "model"))
    b, s = batch["tokens"].shape

    def xent_loss(p, batch):
        """The training loss without its load-balance term: on a mesh that
        term is each shard's own, averaged (the reference's semantics),
        and its gradient reaches the experts of the layers below."""
        hidden, _ = TFM.forward(p, cfg32, batch["tokens"])
        labels = batch["labels"]
        mask = (labels >= 0).float()
        nll = TFM.xent(TFM.logits_fn(p, cfg32, hidden),
                       labels.clamp(min=0).long())
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)

    with RouteLog() as one_log:
        _, g_one = value_and_grad(xent_loss, params, batch)
    with mesh_context(mesh), RouteLog() as mesh_log:
        _, g_mesh = value_and_grad(xent_loss, params, batch)
    mesh_ids = global_routes(torch, mesh_log.calls, mesh_rows(
        torch, MESH_TP_MESH, "tp", b, s), b, s)
    flips = route_flips(mesh_ids, one_log.calls)
    # one device with the mesh's routing forced: the members' router
    # products (1024 rows each) sum in another order than one device's
    # (2048), so a near-tie may route a token elsewhere, and each flip
    # moves a token's share of two experts' gradients
    with RouteLog(forced=mesh_ids):
        _, g_forced = value_and_grad(xent_loss, params, batch)

    def expert_errs(g):
        return sorted(
            (float((a.double() - b.double()).norm()
                   / b.double().norm().clamp(min=1e-30)), path)
            for path, a, b in zip(tree.paths(g_mesh), tree.leaves(g_mesh),
                                  tree.leaves(g))
            if path.rsplit("/", 1)[-1] in ("wg", "wu", "wd")
            and "/moe/" in path)

    errs, free = expert_errs(g_forced), expert_errs(g_one)
    del params, g_one, g_mesh, g_forced, api
    torch.cuda.empty_cache()
    if errs[-1][0] > GRAD_RTOL or (free[-1][0] > GRAD_RTOL and not (
            first_flips_near_ties(flips))):
        fail(f"mesh_train: olmoe's expert gradients on the mesh miss one "
             f"device's beyond {GRAD_RTOL}: {errs[-3:]} with the mesh's "
             f"routing forced, {free[-3:]} without; flips {flips[:12]}")
    # the bf16 steps at the depth olmoe_train runs
    cfg16 = dataclasses.replace(base, grad_accum=1,
                                n_layers=MESH_OLMOE_LAYERS,
                                moe_capacity_factor=nd)
    losses = {}
    for label, mesh_ in (("mesh", mesh), ("one device", None)):
        with tempfile.TemporaryDirectory() as d:
            t = Trainer(cfg16, oshape, ckpt_dir=d, tcfg=tc, mesh=mesh_)
            p, opt = t.init_state()
            run = []
            reset_counts()
            for step in range(MESH_OLMOE_STEPS):
                b16 = batch_tensors(t.data.batch(step), "cuda")
                ctx = mesh_context(mesh_) if mesh_ is not None \
                    else contextlib.nullcontext()
                with ctx:
                    p, opt, metrics = t.step_fn(p, opt, b16, step)
                run.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            if mesh_ is not None:
                o_launches, o_variants = read_counts(), read_variants()
            losses[label] = run
            del t, p, opt
            torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["mesh"],
                                                  losses["one device"]))
    if rel > MESH_LOSS_RTOL or not all(map(math.isfinite, losses["mesh"])):
        fail(f"mesh_train: olmoe's bf16 losses on the mesh {losses}")
    print(f"mesh_train: {MOE_ARCH} under {MESH_TP_MESH}, nothing dropping "
          f"(capacity factor {nd}): float32 gradients of the loss without "
          f"its load-balance term at {MOE_PARITY_LAYERS} layers, "
          f"{oshape.global_batch} x "
          f"{oshape.seq_len} tokens, every expert weight's within "
          f"{errs[-1][0]:.3g} of one device's with the mesh's routing "
          f"forced there (relative L2; largest {errs[-1][1]}, bound "
          f"{GRAD_RTOL}; unforced {free[-1][0]:.3g}: {len(flips)} routing "
          f"flips, the first layer's near-ties within {ROUTER_ATOL}: "
          f"{first_flips_near_ties(flips)}, {flips[:6]}); "
          f"{MESH_OLMOE_STEPS} bf16 steps "
          f"at {MESH_OLMOE_LAYERS} layers: losses {losses['mesh']} against "
          f"one device's {losses['one device']} (relative {rel:.3g}, bound "
          f"{MESH_LOSS_RTOL}), {o_launches['bmm']} bmm launches "
          f"({o_variants['bmm']}); peak "
          f"{gib(torch.cuda.max_memory_allocated())}"
          f"; phase {time.perf_counter() - t_phase:.1f} s on {device_name} "
          f"[{nvidia_smi()}]", flush=True)
    return {"launches": launches, "variants": variants, "seconds": t_mesh,
            "olmoe_launches": o_launches, "shapes": {}}


def mesh_collectives(torch, device_name: str) -> dict:
    """``mesh_collectives``: ``ring_reduce_scatter_matmul`` over
    ``RING_MEMBERS`` members at ``RING_SHAPE`` in bf16 and float32 against
    the flat hand kernel (fp32 out; within the registry's atol 1e-3), in
    int8 at ``RING_INT8_SHAPE`` bitwise against the int64 oracle, its
    bytes moved equal to ``ring_reduce_scatter_bytes``;
    ``quantized_psum`` of 8 x ``QPSUM_ELEMS`` floats within 8
    quantization steps of the sum; ``pipeline_apply`` of qwen's 24
    decoder layers over ``PIPE_STAGES`` stages and ``PIPE_MICRO``
    microbatches bitwise equal to the fold of the same microbatches.
    Returns the launches of all of them (the counted path), each case's
    time and bytes."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime, widesa_mm
    from repro_torch.models import build_model
    from repro_torch.models import transformer as TFM
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import mesh as pm
    from repro_torch.parallel.mesh import P
    from repro_torch.parallel.pipeline import pipeline_apply

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(33)
    ring = pm.make_mesh((RING_MEMBERS,), ("tp",))
    rows, total_launches = {}, None
    total_variants = None

    def tally(launches, variants):
        nonlocal total_launches, total_variants
        if total_launches is None:
            total_launches = dict(launches)
            total_variants = {k: dict(v) for k, v in variants.items()}
            return
        for k in launches:
            total_launches[k] += launches[k]
        for k, v in variants.items():
            for kk in v:
                total_variants[k][kk] += v[kk]

    def run_ring(label, x, w):
        pm.moved_clear()
        xs = pm.shard(ring, x, P(None, "tp"))
        ws = pm.shard(ring, w, P("tp", None))

        def call():
            return C.ring_reduce_scatter_matmul(ring, xs, ws, "tp")

        out, launches, variants, _ = counted_run(torch, call)
        tally(launches, variants)
        got = pm.unshard(ring, out, P("tp", None), x.device)
        chunk = got.shape[0] // RING_MEMBERS * got.shape[1] \
            * got.element_size()
        model = C.ring_reduce_scatter_bytes(chunk, RING_MEMBERS)
        if pm.moved["ppermute"] != model or launches["widesa_mm"] \
                != RING_MEMBERS:
            fail(f"ring {label}: moved {pm.moved}, model {model}, launches "
                 f"{launches}")
        rows[label] = {"ms": time_ms(torch, call, reps=3, warmup=1),
                       "bytes": model, "launches": launches,
                       "variants": variants["widesa_mm"]}
        return got

    m, n, k = RING_SHAPE
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
        w = torch.randn(k, n, generator=gen, device="cuda").to(dtype)
        got = run_ring(dname, x, w)
        tiles = runtime.gemm_tiles(gemm_plan("mm", (m, n, k), dtype), x,
                                   w).tile

        def flat_call():
            return widesa_mm.matmul(x, w, tiles=tiles,
                                    out_dtype=torch.float32)

        flat = flat_call()
        err = (got - flat).abs().max().item()
        if got.dtype != torch.float32 or err > 1e-3:
            fail(f"ring {dname}: {got.dtype}, max |err| {err} against the "
                 "flat hand kernel")
        rows[dname]["max_abs_err"] = err
        rows[dname]["flat_ms"] = time_ms(torch, flat_call, reps=3, warmup=1)
        del x, w, got, flat
    m, n, k = RING_INT8_SHAPE
    x = torch.randint(120, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(120, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    got = run_ring("int8", x, w)
    oracle = (x.double() @ w.double()).to(torch.int64)
    if got.dtype != torch.int32 or not torch.equal(got.to(torch.int64),
                                                   oracle):
        fail(f"ring int8: {got.dtype}, not the int64 oracle's")
    rows["int8"]["max_abs_err"] = 0.0
    del x, w, got, oracle
    qmesh = pm.make_mesh((RING_MEMBERS,), ("dp",))
    g = torch.randn(RING_MEMBERS, QPSUM_ELEMS, generator=gen,
                    device="cuda") * 3
    pm.moved_clear()
    t0 = time.perf_counter()
    out = C.quantized_psum(qmesh, pm.shard(qmesh, g, P("dp", None)), "dp",
                           torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = pm.unshard(qmesh, out, P("dp", None), g.device)
    scale = g.abs().max().item() / 127.0
    err = (got - g.sum(0)).abs().max().item()
    if err >= 8 * scale or not (got == got[0]).all():
        fail(f"quantized_psum: max |err| {err} >= 8 x scale {scale}")
    rows["quantized_psum"] = {"ms": ms, "max_abs_err": err,
                              "steps": err / scale, "moved": dict(pm.moved)}
    del g, out, got
    cfg = get_config(ARCH)
    params = build_model(cfg, "cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    x = torch.randn(PIPE_BATCH, MESH_PROMPT_LEN, cfg.d_model, generator=gen,
                    device="cuda").to(getattr(torch, cfg.dtype))

    def block(lp, h):
        return TFM._block(lp, cfg, h, TFM._positions(h))[0]

    pipe = pm.make_mesh((PIPE_STAGES,), ("pipe",))
    pm.moved_clear()
    t0 = time.perf_counter()
    with torch.no_grad():
        out, launches, variants, _ = counted_run(
            torch, lambda: pipeline_apply(block, params["layers"], x,
                                          mesh=pipe,
                                          microbatches=PIPE_MICRO))
    ms = (time.perf_counter() - t0) * 1e3
    tally(launches, variants)
    moved = dict(pm.moved)
    with torch.no_grad():
        folds = []
        for mb in x.chunk(PIPE_MICRO):
            for lp in params["layers"]:
                mb = block(lp, mb)
            folds.append(mb)
        want = torch.cat(folds)
    if not torch.equal(out, want):
        fail(f"pipeline_apply: max |diff| "
             f"{(out.float() - want.float()).abs().max().item()} from the "
             "fold of the same microbatches")
    ticks = PIPE_MICRO + PIPE_STAGES - 1
    rows["pipeline"] = {"ms": ms, "moved": moved, "launches": launches,
                        "ticks": ticks}
    del params, x, out, want, folds
    torch.cuda.empty_cache()
    for label in ("bfloat16", "float32", "int8"):
        r = rows[label]
        print(f"mesh_collectives: ring_reduce_scatter_matmul "
              f"{RING_SHAPE if label != 'int8' else RING_INT8_SHAPE} {label}"
              f" over {RING_MEMBERS} members: {r['launches']['widesa_mm']} "
              f"partials on B1 ({r['variants']}), max |err| "
              f"{r['max_abs_err']:.3g} against the "
              f"{'flat hand kernel' if label != 'int8' else 'int64 oracle'}, "
              f"{r['bytes']} bytes moved (the ring's hops x chunk: "
              f"ring_reduce_scatter_bytes), {r['ms']:.3f} ms (CUDA events"
              + (f"; the flat kernel {r['flat_ms']:.3f} ms" if "flat_ms" in r
                 else "") + ")", flush=True)
    q = rows["quantized_psum"]
    print(f"mesh_collectives: quantized_psum of {RING_MEMBERS} x "
          f"{QPSUM_ELEMS} floats: max |err| {q['max_abs_err']:.4f} = "
          f"{q['steps']:.2f} quantization steps (bound 8), moved "
          f"{q['moved']} (a ring all-reduce of the int32 payload would move "
          f"{C.ring_allreduce_bytes(QPSUM_ELEMS * 4, RING_MEMBERS)}), "
          f"{q['ms']:.2f} ms", flush=True)
    pr = rows["pipeline"]
    print(f"mesh_collectives: pipeline_apply of {ARCH}'s {cfg.n_layers} "
          f"layers over {PIPE_STAGES} stages, {PIPE_MICRO} microbatches of "
          f"{PIPE_BATCH // PIPE_MICRO} x {MESH_PROMPT_LEN}: bitwise the fold "
          f"of the same microbatches; {ticks} ticks of {PIPE_STAGES} stages "
          f"x {cfg.n_layers // PIPE_STAGES} layers ({ticks * PIPE_STAGES} "
          f"stage runs for {PIPE_MICRO * PIPE_STAGES} of work: the GPipe "
          f"bubble), {pr['launches']['widesa_mm']} mm and "
          f"{pr['launches']['bmm']} bmm launches, moved {pr['moved']}, "
          f"{pr['ms']:.1f} ms; phase {time.perf_counter() - t_phase:.1f} s "
          f"on {device_name} [{nvidia_smi()}]", flush=True)
    partial = ("mm", (RING_SHAPE[0], RING_SHAPE[1],
                      RING_SHAPE[2] // RING_MEMBERS))
    return {"launches": total_launches, "variants": total_variants,
            "rows": rows, "shapes": {partial + (d,): RING_MEMBERS
                                     for d in ("bfloat16", "float32")}}


def ring_int8_timing(torch) -> dict:
    """The int8 ring partial (``RING_INT8_SHAPE`` over its members) on B1
    against the plain version and ``torch._int_mm``."""
    from repro_torch.kernels import ref

    m, n, k = RING_INT8_SHAPE
    k //= RING_MEMBERS
    gen = torch.Generator(device="cuda").manual_seed(34)
    a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    fn, tiles = kernel_call("mm", (m, n, k), torch.int8, a, b)
    kernel = ("gemm_tc_int_kernel" if tiles.tile.__class__.__name__
              == "TcTile" else "gemm_kernel")
    err, ok = max_error(torch, fn(a, b), ref.mm(a, b), torch.int32)
    if not ok:
        fail(f"ring int8 partial: max |err| {err}")
    try:
        lib = device_ms(torch, lambda: torch._int_mm(a, b))
    except RuntimeError:
        lib = None
    bound, by = bound_ms("mm", (m, n, k), 1, 4, "int8")
    # a profiler reading below the bound lost records: CUDA events stand
    ms = device_ms(torch, lambda: fn(a, b))
    if ms is None or ms < bound:
        ms = time_ms(torch, lambda: fn(a, b))
    row = {"kernel": kernel, "max_abs_err": err, "ms": ms,
           "plain_ms": time_ms(torch, lambda: ref.mm(a, b), reps=5,
                               warmup=1),
           "library_ms": lib, "bound_ms": bound, "bound_by": by}
    print(f"time mm{(m, n, k)} int8->int32 [ring partial, int8] {kernel}: "
          f"device {fmt_ms(row['ms'])}, torch._int_mm {fmt_ms(lib)}, bound "
          f"{bound:.4f} ms ({by}); plain {row['plain_ms']:.4f} ms",
          flush=True)
    return row


def mesh_phase(torch, device_name: str) -> dict:
    """Phase 12d: the mesh paths on ``MESH_DEVICES`` logical devices of
    this card (``parallel.mesh.logical_devices``): ``mesh_moe_ep``,
    ``mesh_moe_tp``, ``mesh_train`` and ``mesh_collectives``, each a path
    of the kernels line; then ``MESH_SHAPES`` and the int8 ring partial
    timed.  Every member computes on its hand kernels, one after another:
    each time is the members' work serialized on one card plus their
    copies, not a speed."""
    from repro_torch.parallel import mesh as pm

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    paths = {}
    with pm.logical_devices(MESH_DEVICES):
        if pm.devices() != [torch.device("cuda", i % torch.cuda.device_count())
                            for i in range(MESH_DEVICES)]:
            fail(f"mesh: logical devices {pm.devices()}")
        for label, fn in (("mesh_moe_ep", mesh_moe_ep),
                          ("mesh_moe_tp", mesh_moe_tp),
                          ("mesh_train", mesh_train),
                          ("mesh_collectives", mesh_collectives)):
            paths[label] = fn(torch, device_name)
            torch.cuda.empty_cache()
    rows = {}
    for i, entry in enumerate(MESH_SHAPES):
        (key, row), = gemm_timings(torch, (entry,), seed=35 + i).items()
        rows[key + (entry[-1],)] = row
    rows[("mm", "ring int8")] = ring_int8_timing(torch)
    torch.cuda.empty_cache()
    print(f"mesh: phase done in {time.perf_counter() - t0:.1f} s, allocated "
          f"peak {gib(torch.cuda.max_memory_allocated())}, on {device_name} "
          f"[{nvidia_smi()}]", flush=True)
    return {"paths": paths, "rows": rows}


#: the dry-run phase's steps of qwen1.5-0.5b: its 4-lane decode step over a
#: cache of DRYRUN_SEQ rows and one 512-token prefill
DRYRUN_SEQ = 512
DRYRUN_LANES = 4
#: the dry run's bytes against the allocator's: the caching allocator
#: rounds a block under 1 MiB up to whole 512-byte units, and leaves a
#: larger block up to 1 MiB of its segment that it does not split off
ALLOC_UNIT = 512
ALLOC_LARGE = 2**20
#: ``--dryrun``'s grid: a cell a core of the card's host, and a cell past
#: 45 minutes fails (deepseek-v2's EP train cells run 256-512 members a
#: layer through 8 microbatches)
DRYRUN_JOBS = 8
DRYRUN_CELL_SECONDS = 2700


def alloc_slack(nbytes: int) -> int:
    """The most the caching allocator's block for ``nbytes`` exceeds it."""
    return ALLOC_UNIT if nbytes < ALLOC_LARGE else ALLOC_LARGE + ALLOC_UNIT


def dryrun_step(torch, api, shape, params):
    """One real step of ``launch/dryrun.py``'s cell ``shape`` on
    ``params``: the decode step on a fresh cache or the prefill."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    with torch.no_grad():
        if shape.kind == "decode":
            cache = api.init_cache(shape.global_batch, shape.seq_len)
            tokens = torch.randint(0, api.cfg.vocab, (shape.global_batch, 1),
                                   generator=gen, device="cuda",
                                   dtype=torch.int32)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = api.decode(params, cache, tokens)
        else:
            tokens = torch.randint(0, api.cfg.vocab,
                                   (shape.global_batch, shape.seq_len),
                                   generator=gen, device="cuda",
                                   dtype=torch.int32)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = api.prefill(params, {"tokens": tokens}, shape.seq_len)
        torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def dryrun_phase(torch, device_name: str) -> dict:
    """Phase 12e: the dry run (``launch/dryrun.py``) against the card.
    qwen1.5-0.5b's 4-lane decode step and a 512-token prefill are counted
    on fake tensors on a 1 x 1 mesh, the whole step (``"counted"``), then
    run for real on the same weights' shapes.  Fails unless the fake
    launches, by kernel and variant, equal the wrappers' real
    ``launches``/``variants``, and the argument bytes of the parameters
    equal the real leaves' storage bytes and the
    ``torch.cuda.memory_allocated`` delta of building them within the
    allocator's rounding (``alloc_slack``); prints the predicted
    activation peak
    against the real step's ``max_memory_allocated`` above its
    arguments."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.fakecuda import fake_cuda
    from repro_torch.models.model import build_model
    from repro_torch.parallel import mesh as pm
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    cfg = get_config("qwen1.5-0.5b")
    shapes = (ShapeSpec("decode_4x512", "decode", DRYRUN_SEQ, DRYRUN_LANES),
              ShapeSpec("prefill_512", "prefill", DRYRUN_SEQ, 1))
    fake = {}
    with fake_cuda():
        mesh = pm.make_mesh((1, 1), ("data", "model"), DR.fake_devices(1))
        for shape in shapes:
            fake[shape.name] = DR.count_cell(cfg, shape, mesh,
                                             mesh_name="1x1",
                                             accounting="counted")
    t_fake = time.perf_counter() - t0
    api = build_model(cfg, device="cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    built = torch.cuda.memory_allocated() - before
    sizes = [t.untyped_storage().nbytes() for t in leaves(params)]
    slack = sum(alloc_slack(n) for n in sizes)
    launches = dict.fromkeys(wrappers(), 0)
    variants = {k: dict(v) for k, v in read_variants().items()}
    for v in variants.values():
        for key in v:
            v[key] = 0
    for shape in shapes:
        res = fake[shape.name]
        (_, peak), counts, by_kernel, _ = counted_run(
            torch, lambda: dryrun_step(torch, api, shape, params))
        real = {f"{w}/{k}": n for w, kv in by_kernel.items()
                if w in ("widesa_mm", "bmm") for k, n in kv.items() if n}
        faked = {k.replace("mm/", "widesa_mm/", 1)
                 if k.startswith("mm/") else k: n
                 for k, n in res.kernels.items()}
        if real != faked:
            fail(f"dryrun {shape.name}: fake launches {faked} != real "
                 f"{real}")
        param_b = res.memory["parameter_bytes"]
        if param_b != sum(sizes) or not 0 <= built - param_b <= slack:
            fail(f"dryrun {shape.name}: parameter bytes {param_b} against "
                 f"{sum(sizes)} in {len(sizes)} leaves, an allocated delta "
                 f"of {built} (rounding at most {slack})")
        ratio = res.memory["temp_bytes"] / peak if peak else float("nan")
        print(f"dryrun {shape.name}: fake launches == real {real}; "
              f"argument bytes {res.memory['argument_bytes']} (parameters "
              f"{param_b} == the {len(sizes)} leaves' storage, allocated "
              f"delta {built}, rounding at most {slack}); "
              f"flops_global {res.flops_global:.6e}, bytes_global "
              f"{res.bytes_global:.6e}; predicted activation peak "
              f"{res.memory['temp_bytes']} B against max_memory_allocated "
              f"{peak} B above the arguments: ratio {ratio:.4f}",
              flush=True)
        for w, n in counts.items():
            launches[w] += n
        for w, kv in by_kernel.items():
            for k, n in kv.items():
                variants[w][k] += n
    del params
    torch.cuda.empty_cache()
    print(f"dryrun: phase done in {time.perf_counter() - t0:.1f} s "
          f"({t_fake:.1f} s on fake tensors), on {device_name} "
          f"[{nvidia_smi()}]", flush=True)
    return {"paths": {"dryrun": {"launches": launches, "variants": variants,
                                 "shapes": {}}}}


def dryrun_grid(torch, out: Path) -> None:
    """``--dryrun``: every arch x ``cells_for`` x both production meshes
    through ``launch/dryrun.py`` (``DRYRUN_JOBS`` processes, each cell cut
    at ``DRYRUN_CELL_SECONDS``), one line a cell and the roofline table;
    every cell succeeds or names its error; one JSON a cell in ``out``.
    Every cell is counted afresh: no earlier JSON in ``out`` is read."""
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.core import roofline as RL
    from repro_torch.launch import dryrun as DR

    t0 = time.perf_counter()
    results = DR.run_cells(ARCHS, list(SHAPES), [False, True], str(out),
                           jobs=DRYRUN_JOBS, cell_timeout=DRYRUN_CELL_SECONDS,
                           reuse=False)
    rows = [DR.roofline_of(r) for r in results if r["ok"]]
    print(RL.format_table(rows))
    bad = [r for r in results if not r["ok"]]
    for r in bad:
        if not r["error"].strip():
            fail(f"dryrun {r['arch']} x {r['shape']} x {r['mesh']}: failed "
                 "without an error")
        print(f"dryrun FAILED: {DR.cell_line(r)}")
    print(f"dryrun grid: {len(results) - len(bad)}/{len(results)} cells OK "
          f"in {time.perf_counter() - t0:.1f} s ({DRYRUN_JOBS} processes), "
          f"results in {out}", flush=True)


#: element types of the mangled template arguments of the kernels the
#: build line lists one by one
MANGLED_TYPES = {"f": "float32", "a": "int8", "s": "int16", "i": "int32"}


def kernel_resources(log: str) -> list[str]:
    """Registers and spill stores of each instantiation of the fused fft2d
    kernel and of the FFT kernel's two passes, of the tensor-core MTTKRP
    kernel, of the integer tensor-core
    GEMM and its limb pre-pass, of the FIR kernel (real and complex), and
    of the window kernels (conv2d and the one-sweep star) and the
    multi-sweep star, from ``ptxas -v``'s lines in the build log."""
    found, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        regs = re.search(r"Used (\d+) registers", line)
        if name and spill:
            found.append([name, None, int(spill.group(1))])
        elif name and regs and found and found[-1][0] == name:
            found[-1][1] = int(regs.group(1))
    out = []
    for mangled, regs, spill in found:
        tc = re.search(r"mttkrp_tc_kernelI(\w)\wLi(\d+)E", mangled)
        if tc:
            label = (f"mttkrp_tc_kernel<{MANGLED_TYPES[tc.group(1)]}, copy "
                     f"{tc.group(2)}>")
        elif "fft2d_kernel" in mangled:
            label = "fft2d_kernel"
        elif fftp := re.search(r"fft_pass_kernelILb(\d)E", mangled):
            label = ("fft_pass_kernel<columns>" if fftp.group(1) == "1"
                     else "fft_pass_kernel<rows>")
        elif gemm := re.search(r"gemm_tc_int_kernelILi(\d)ELi(\d+)ELi(\d+)E",
                               mangled):
            label = (f"gemm_tc_int_kernel<{gemm.group(1)} limb(s), "
                     f"{gemm.group(2)}x{gemm.group(3)}>")
        elif limb := re.search(r"limb_planes_kernelI(\w)E", mangled):
            label = f"limb_planes_kernel<{MANGLED_TYPES[limb.group(1)]}>"
        elif conv := re.search(
                r"conv2d_kernelI(\w)\wLi(\d+)ELi(\d+)ELb(\d)E", mangled):
            label = (f"conv2d_kernel<{MANGLED_TYPES[conv.group(1)]}, "
                     f"{conv.group(2)}x{conv.group(3)}"
                     f"{', generic' if conv.group(4) == '1' else ''}>")
        elif fir := re.search(r"fir_kernelI(\w)\wLi(\d+)ELi(\d)E", mangled):
            taps = fir.group(2) if fir.group(2) != "0" else "generic"
            label = (f"fir_kernel<{MANGLED_TYPES[fir.group(1)]}, {taps} taps"
                     f"{', complex' if fir.group(3) == '2' else ''}>")
        elif star := re.search(r"star_kernelI(\w)\wLi(\d+)E", mangled):
            label = (f"star_kernel<{MANGLED_TYPES[star.group(1)]}, "
                     f"{star.group(2)} points>")
        elif sweeps := re.search(r"sweeps_kernelI(\w)\wE", mangled):
            label = f"sweeps_kernel<{MANGLED_TYPES[sweeps.group(1)]}>"
        else:
            continue
        out.append(f"{label} {regs} registers, {spill} B spill")
    return out


def fft_entry(fft2d_entry: dict, k: dict, row: dict) -> dict:
    """The kernels line's entry of the FFT kernel (``fft_pass_kernel``):
    its launches on every path are those the fft2d wrapper counted under
    its ``fft`` form (``fft2d_entry``, the entry before it); its times
    are the pipeline's bench grid's (``fft_bench_timing``), the
    composition's beside them."""
    return {
        "name": "fft2d_fft", "route": "cuda", "source": k["source"],
        "replaces": k["replaces"],
        "launches": {path: forms["fft"] for path, forms in
                     fft2d_entry["launches_by_kernel"].items()},
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "shape": "fft2d(8192, 8192) float32 planes", "tile": str(row["tiles"]),
        **{key: row[key] for key in (
            "device_ms", "library_device_ms", "composition_ms",
            "composition_device_ms", "dft_bound_ms", "plain_max_abs_err",
            "bitwise")}}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="On-card smoke of the port.")
    ap.add_argument("--tile-sweep", action="store_true",
                    help="only time every sweep tile at the main-path "
                         "shapes")
    ap.add_argument("--mttkrp-sweep", action="store_true",
                    help="only time the tensor-core MTTKRP with every split "
                         "of K at the bench size")
    ap.add_argument("--fft-sweep", action="store_true",
                    help="only time the fused fft2d kernel with every split "
                         "of K at the frontend and pipeline grids, and the "
                         "FFT kernel with its configurations at 8192^2 and "
                         "4096 x 256")
    ap.add_argument("--skinny-sweep", action="store_true",
                    help="only time the skinny GEMM with every split of K "
                         "at the MoE router's and other small-B shapes")
    ap.add_argument("--tc-sweep", action="store_true",
                    help="only time the tensor-core GEMM with every tile, "
                         "split and ring depth at the prefill shapes")
    ap.add_argument("--conv2d-sweep", action="store_true",
                    help="only time conv2d at the bench size with filters "
                         "from 3 x 3 to 32 x 32")
    ap.add_argument("--fir-sweep", action="store_true",
                    help="only time FIR from 2^20 to 2^26 outputs at 7, "
                         "15, 64 and 255 taps (float32) and at the bench and "
                         "frontend shapes in int8 and int16")
    ap.add_argument("--train", action="store_true",
                    help="only the device, the GEMM build and the train "
                         "phases")
    ap.add_argument("--dense", action="store_true",
                    help="only the device, the GEMM build and the "
                         "dense_configs and deepseek phases")
    ap.add_argument("--hier", action="store_true",
                    help="only the device, the GEMM and stencil builds and "
                         "the hier phase (two-level plans)")
    ap.add_argument("--systolic", action="store_true",
                    help="only the device, the build and the systolic "
                         "phase (the chip-level schedules on logical "
                         "meshes)")
    ap.add_argument("--mesh", action="store_true",
                    help="only the device, the GEMM build and the mesh "
                         "phase (the MoE mesh paths, training and the "
                         "collectives on logical meshes)")
    ap.add_argument("--dryrun", action="store_true",
                    help="only the device, the GEMM build, the dryrun "
                         "phase and the dry run of every cell "
                         "(launch/dryrun.py) on both production meshes")
    ap.add_argument("--src", help="with --conv2d-sweep or --fir-sweep: the "
                                  "src/ directory of another checkout of "
                                  "the port, whose kernel to time instead")
    ap.add_argument("--out", help="with a sweep: write the times here as "
                                  "JSON; with --dryrun: the cells' "
                                  "directory (default results/dryrun_torch)")
    args = ap.parse_args(argv)
    if args.src:
        if not (args.conv2d_sweep or args.fir_sweep):
            ap.error("--src needs --conv2d-sweep or --fir-sweep")
        sys.path.insert(0, str(Path(args.src).resolve()))

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    # the plain versions run PyTorch's fp32 GEMMs: keep them in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {name} [{smi}], {torch.cuda.device_count()} visible; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    paths = build.build(("widesa_hpc",) if args.mttkrp_sweep
                        else ("widesa_mm",)
                        if args.tc_sweep or args.skinny_sweep or args.train
                        or args.dense or args.mesh or args.dryrun
                        else ("widesa_mm", "widesa_hpc") if args.hier
                        else ("widesa_mm", "widesa_sp", "widesa_fft")
                        if args.fft_sweep
                        else ("widesa_sp",)
                        if args.conv2d_sweep or args.fir_sweep
                        else tuple(build.SOURCES))
    for lib in paths:
        build.library(lib)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                       build.build_log)]
    spills = re.findall(r"(\d+) bytes spill stores", build.build_log)
    print(f"build: {', '.join(p.name for p in paths.values())} ready in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds:.1f} "
          f"s on the wall clock, one process per source; {len(regs)} "
          f"kernels, at most {max(regs, default=0)} registers a thread, "
          f"{sum(int(x) for x in spills)} bytes of spill stores; "
          f"{'; '.join(kernel_resources(build.build_log))})", flush=True)

    if args.mttkrp_sweep or args.tc_sweep or args.fft_sweep \
            or args.conv2d_sweep or args.fir_sweep or args.skinny_sweep:
        rows = (mttkrp_sweep(torch) if args.mttkrp_sweep
                else tc_sweep(torch) if args.tc_sweep
                else skinny_sweep(torch) if args.skinny_sweep
                else conv2d_sweep(torch) if args.conv2d_sweep
                else fir_sweep(torch) if args.fir_sweep
                else fft_sweep(torch))
        if args.out:
            Path(args.out).write_text(json.dumps(rows, indent=1))
        return 0
    if args.train:
        for phase in TRAIN_PHASES:
            train_phase(torch, name, *phase)
        for phase in SLICE_TRAIN:
            slice_train_phase(torch, name, *phase)
        dots_phase(torch, name)
        return 0
    if args.dense:
        dense_phase(torch, name)
        deepseek_phase(torch, name)
        return 0
    if args.hier:
        hier_phase(torch, name)
        return 0
    if args.systolic:
        systolic_phase(torch, name)
        return 0
    if args.mesh:
        mesh_phase(torch, name)
        return 0
    if args.dryrun:
        dryrun_phase(torch, name)
        dryrun_grid(torch, Path(args.out) if args.out
                    else ROOT / "results" / "dryrun_torch")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    if args.tile_sweep:
        t0 = time.perf_counter()
        build.library("widesa_mm", sweep=True)
        print(f"build: sweep library ({len(build.SWEEP_TILES)} tiles) ready "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        rows = tile_sweep(torch)
        if args.out:
            Path(args.out).write_text(json.dumps(rows, indent=1))
        return 0
    parity(torch)
    skinny_long_sums(torch)
    tc_parity(torch)
    sp_parity(torch)
    fft_parity(torch)
    rows = timings(torch)
    tc_rows = tc_timings(torch)
    rows.update(sp_timings(torch))
    tiled_timing(torch)
    print("kernels: widesa_mm (B1, widesa_mm.py mm_kernel -> cuda), bmm "
          "(B2, bmm.py bmm_kernel -> cuda) in " + SOURCE + " (skinny_kernel "
          "for M <= 16 at any K, gemm_tc_kernel on wgmma above in bf16 and "
          "float32, its ring filled by TMA (wgmma) or, for an operand TMA "
          "cannot address, by cp.async copies (wgmma_cp), "
          "gemm_tc_int_kernel on wgmma above in int8, int16 and int32 after "
          "limb_planes_kernel (counted as wgmma); gemm_kernel tiled for B "
          "rows that allow no 4-byte copy and integer K past 8 ranks); "
          "fir (B3, fir.py fir_kernel "
          "-> cuda: fir_kernel, compiled 15 taps and a generic "
          "instantiation, real and complex (fir_complex, ops.fir_complex, "
          "one launch)), conv2d (B5, conv2d.py conv_kernel -> cuda: "
          "conv2d_kernel, compiled 4x4 / 8x8 / 5x4 windows and a generic "
          "one) in "
          + SP_SOURCE + "; fft2d (B4, fft2d.py fft2d/_cmul_mm -> cuda, "
          "fft2d_kernel in " + SP_SOURCE + " up to 64 rows, fft_pass_kernel "
          "(fft2d_fft: row and column passes of Stockham FFTs) in "
          + FFT_SOURCE + " above for power-of-two sides up to 8192, the "
          "composition over the GEMMs above for the rest); jacobi2d (B6, jacobi2d.py jacobi_kernel -> "
          "cuda: star_kernel for one sweep, sweeps_kernel for T_b sweeps of "
          "jacobi2d_ms a launch), mttkrp (B7, mttkrp.py mttkrp_kernel -> cuda: "
          "mttkrp_tc_kernel on wgmma, float32 as 3xTF32, int8, int16 and "
          "int32 as int8 limbs; mttkrp_kernel on the CUDA cores for the "
          "rest) in " + HPC_SOURCE,
          flush=True)
    torch.cuda.empty_cache()

    launches, variants, slot = serve(torch, name)
    torch.cuda.empty_cache()
    paged_launches, paged_variants, _ = serve(torch, name, slot)
    del slot
    torch.cuda.empty_cache()
    prefill_launches, prefill_variants = prefill_phase(torch, name)
    torch.cuda.empty_cache()
    stream_launches, stream_variants, slot = stream_serve(torch, name)
    torch.cuda.empty_cache()
    pstream_launches, pstream_variants, _ = stream_serve(torch, name, slot)
    del slot
    torch.cuda.empty_cache()
    long_paths = {}
    for path, phase in (("qwen_long", long_prompt),
                        ("whisper_offline", offline_audio)):
        out = phase(torch, name)
        long_paths[path] = {key: out[key]
                            for key in ("launches", "variants", "shapes")}
        del out
        torch.cuda.empty_cache()
    hier = hier_phase(torch, name)
    hier_paths = hier["paths"]
    torch.cuda.empty_cache()
    systolic = systolic_phase(torch, name)
    hier_paths.update(systolic["paths"])
    torch.cuda.empty_cache()
    moe_paths = moe_phase(torch, name)
    torch.cuda.empty_cache()
    ssm_paths = ssm_phase(torch, name)
    torch.cuda.empty_cache()
    dense = dense_phase(torch, name)
    dense_paths = dense["paths"]
    torch.cuda.empty_cache()
    deepseek = deepseek_phase(torch, name)
    dense_paths.update(deepseek["paths"])
    torch.cuda.empty_cache()
    mesh = mesh_phase(torch, name)
    mesh_paths = mesh["paths"]
    torch.cuda.empty_cache()
    mesh_paths.update(dryrun_phase(torch, name)["paths"])
    torch.cuda.empty_cache()
    train_paths = {phase[0]: train_phase(torch, name, *phase)
                   for phase in TRAIN_PHASES}
    torch.cuda.empty_cache()
    for phase in SLICE_TRAIN:
        train_paths[phase[0]] = slice_train_phase(torch, name, *phase)
    train_paths["train_dots"] = dots_phase(torch, name)
    no_xla_stamp()
    train_paths["autotune"] = autotune_phase(torch, name)
    torch.cuda.empty_cache()
    long_rows = gemm_timings(torch)
    moe_rows = gemm_timings(torch, MOE_SHAPES, seed=15)
    ssm_rows = gemm_timings(torch, SSM_SHAPES, seed=17)
    torch.cuda.empty_cache()
    rec_launches, rec_variants, hpc_rows, gemm_rows = \
        recurrences_phase(torch)
    rows[("fft2d_fft", "main")] = fft_bench_timing(torch)
    rows.update({(kname, "main"): hpc_rows[(kname, "float32")]
                 for kname in ("jacobi2d", "mttkrp")})

    summary = []
    for kname, k in KERNELS.items():
        row = rows[(k["kind"], k["shape"], k["col_major"])] if "kind" in k \
            else rows[(kname, "main")]
        if kname == "fft2d_fft":
            summary.append(fft_entry(summary[-1], k, row))
            continue
        entry = {
            "name": kname, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": {"qwen": launches[kname],
                         "qwen_paged": paged_launches[kname],
                         "qwen_prefill": prefill_launches[kname],
                         "whisper_stream": stream_launches[kname],
                         "whisper_paged": pstream_launches[kname],
                         **{path: long_paths[path]["launches"][kname]
                            for path in long_paths},
                         **{path: hier_paths[path]["launches"][kname]
                            for path in hier_paths},
                         **{path: moe_paths[path]["launches"][kname]
                            for path in moe_paths},
                         **{path: ssm_paths[path]["launches"][kname]
                            for path in ssm_paths},
                         **{path: dense_paths[path]["launches"][kname]
                            for path in dense_paths},
                         **{path: train_paths[path]["launches"][kname]
                            for path in train_paths},
                         **{path: mesh_paths[path]["launches"][kname]
                            for path in mesh_paths},
                         "recurrences": rec_launches[kname]},
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        }
        if kname in variants:
            # launches by kernel per path, and device times: the GEMMs'
            # (the tiled kernel's beside) with the host time of a wrapper
            # call, mttkrp's (the CUDA-core kernel's beside), fft2d's (the
            # composition's beside), conv2d's and the stars' (the library
            # call's beside); conv2d's by window, the stars' by kernel
            entry["launches_by_kernel"] = {
                "qwen": variants[kname],
                "qwen_paged": paged_variants[kname],
                "qwen_prefill": prefill_variants[kname],
                "whisper_stream": stream_variants[kname],
                "whisper_paged": pstream_variants[kname],
                **{path: long_paths[path]["variants"][kname]
                   for path in long_paths},
                **{path: hier_paths[path]["variants"][kname]
                   for path in hier_paths},
                **{path: moe_paths[path]["variants"][kname]
                   for path in moe_paths},
                **{path: ssm_paths[path]["variants"][kname]
                   for path in ssm_paths},
                **{path: dense_paths[path]["variants"][kname]
                   for path in dense_paths},
                **{path: train_paths[path]["variants"][kname]
                   for path in train_paths},
                **{path: mesh_paths[path]["variants"][kname]
                   for path in mesh_paths},
                "recurrences": rec_variants[kname]}
            keys = {"mttkrp": ("device_ms", "cuda_core_device_ms",
                               "library_device_ms", "cuda_core_bound_ms"),
                    "fft2d": ("device_ms", "composition_device_ms",
                              "library_device_ms", "dft_bound_ms"),
                    "conv2d": ("device_ms", "library_device_ms"),
                    "fir": ("device_ms", "generic_device_ms",
                            "library_device_ms", "copy_device_ms"),
                    "jacobi2d": ("device_ms", "library_device_ms")}.get(
                kname, ("device_ms", "tiled_device_ms", "library_device_ms",
                        "host_us", "facade_us"))
            entry.update({key: row[key] for key in keys})
        if kname in ("conv2d", "fir"):
            # the paper's conv2d and FIR tables: each bench case (FIR's
            # cfloat on float32 planes, and fir_complex in one launch)
            entry["bench"] = {
                (where.removeprefix("bench ") if name == kname
                 else "fir_complex float32"): {
                    key: r.get(key) for key in (
                        "ms", "device_ms", "generic_device_ms", "plain_ms",
                        "library_ms", "library_device_ms", "copy_device_ms",
                        "four_conv1d_device_ms", "launches", "bound_ms",
                        "max_abs_err")}
                for (name, where, *_), r in rows.items()
                if name in (kname, kname + "_complex")
                and str(where).startswith("bench")}
        if kname == "jacobi2d":
            # the other stars and dtypes timed, and jacobi2d_ms's call
            entry["timed"] = {
                f"{name} {dtype}": {key: r.get(key) for key in (
                    "ms", "device_ms", "plain_ms", "library_ms",
                    "library_device_ms", "bound_ms", "max_abs_err",
                    "copy_device_ms", "launches", "host_ms", "floor_ms",
                    "device_ms_by_sweeps")}
                for (name, dtype), r in hpc_rows.items()
                if name.startswith("jacobi2d")}
        if kname in ("widesa_mm", "bmm"):
            # the GEMMs the long prompts and the offline encoder add, each
            # with its launches on those two paths
            kind = KERNELS[kname]["kind"]
            entry["long"] = {
                f"{kind}{shape}": {**{key: r[key] for key in (
                    "kernel", "ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "max_abs_err")},
                    "launches": {
                        path: long_paths[path]["shapes"][(kind, shape)]
                        for path in long_paths}}
                for (k, shape), r in long_rows.items() if k == kind}
            # the MoE path's router (float32) and expert stack, each with
            # its launches on the olmoe paths
            entry["moe"] = {
                f"{kind}{shape} {dname}": {**{key: moe_rows[(kind, shape)][
                    key] for key in ("kernel", "ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by",
                                     "max_abs_err")},
                    "launches": {path: moe_paths[path]["shapes"][
                        (kind, shape)] for path in moe_paths}}
                for _, k, shape, *_, dname in MOE_SHAPES if k == kind}
            # the SSM and hybrid models' lm_heads and zamba2's shared block,
            # each with its launches on the mamba2 and zamba2 paths
            ssm_entry = {
                f"{kind}{shape}": {**{key: ssm_rows[(kind, shape)][key]
                                      for key in ("kernel", "ms", "plain_ms",
                                                  "library_ms", "bound_ms",
                                                  "bound_by", "max_abs_err")},
                                   "launches": {path: ssm_paths[path][
                                       "shapes"][(kind, shape)]
                                       for path in ssm_paths}}
                for _, k, shape, *_ in SSM_SHAPES if k == kind}
            if ssm_entry:
                entry["ssm"] = ssm_entry
            # the dense configs' new shapes (llava's patch projection,
            # stablelm's head dim 160, codeqwen's and qwen3-32b's decode
            # GEMMs, qwen3-32b's 16-row down projection), each with its
            # launches on its model's slot and paged paths
            dense_entry = {
                f"{kind}{shape} [{model}]": {
                    **{key: dense["rows"][model][(kind, shape)][key]
                       for key in ("kernel", "ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by", "max_abs_err")},
                    "launches": {path: dense_paths[path]["shapes"][
                        (kind, shape)] for path in (model, f"{model}_paged")}}
                for model, timed in DENSE_SHAPES.items()
                for _, k, shape, *_ in timed if k == kind}
            if dense_entry:
                entry["dense"] = dense_entry
            # the MLA path's new shapes (deepseek-v2-236b at 8 layers), each
            # with its launches on the deepseek slot and paged paths
            deepseek_entry = {
                f"{kind}{shape} {label}": {
                    **{key: deepseek["rows"][(kind, shape)][key]
                       for key in ("kernel", "ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by", "max_abs_err")},
                    "launches": {path: dense_paths[path]["shapes"][
                        (kind, shape)] for path in ("deepseek",
                                                    "deepseek_paged")}}
                for label, k, shape, *_ in DEEPSEEK_SHAPES if k == kind}
            if deepseek_entry:
                entry["deepseek"] = deepseek_entry
            # the mesh paths' member GEMMs: each member's expert bmm under
            # EP and TP, the ring's partials (its launches on the counted
            # paths: every member's expert stack, each ring member's one)
            mesh_entry = {
                f"{k}{shape} {dname} [{label}]": {
                    **{key: mesh["rows"][(k, shape, dname)][key] for key in (
                        "kernel", "ms", "plain_ms", "library_ms",
                        "bound_ms", "bound_by", "max_abs_err")},
                    "launches": {path: mesh_paths[path]["shapes"].get(
                        (k, shape, dname), 0) for path in mesh_paths}}
                for label, k, shape, *_, dname in MESH_SHAPES if k == kind}
            if kname == "widesa_mm":
                m8, n8, k8 = RING_INT8_SHAPE
                mesh_entry[f"mm{(m8, n8, k8 // RING_MEMBERS)} int8 [ring "
                           "partial, int8]"] = {
                    **mesh["rows"][("mm", "ring int8")],
                    "launches": {"mesh_collectives": RING_MEMBERS}}
            entry["mesh"] = mesh_entry
            # the backward GEMMs of the train paths, each with its launches
            # in one train step (every site of that shape, the remat
            # recompute's forward launches included)
            entry["train"] = {
                f"{kind}{shape}": {**{key: r[key] for key in (
                    "kernel", "ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "max_abs_err")},
                    "launches_per_step": {path: out["per_step"][(kind, shape)]
                                          for path, out in train_paths.items()
                                          if (kind, shape) in out["per_step"]}}
                for out in train_paths.values()
                for (k, shape), r in out["rows"].items() if k == kind}
        if kname in ("widesa_mm", "bmm", "jacobi2d"):
            # the hier phase's (d): each recurrence under the serving
            # target on the hand kernels, beside the flat plan and the
            # plain version; (c): B read at its pitch (mm)
            kind = KERNELS[kname].get("kind", kname)
            entry["hier"] = {
                label: row for label, row in hier["recurrences"].items()
                if row["kind"] == kind
                or (kname == "jacobi2d" and row["kind"].startswith(kind))}
            if kname == "widesa_mm":
                entry["pitched"] = hier["pitched"]
        if kname in WGMMA_SHAPES:
            # the tensor-core kernel at its prefill shape, the tiled
            # kernel and the library call beside it; the integer one at
            # the paper's int8 shape (gemm_tc_int_kernel with its limb
            # pre-pass), the tiled kernel and torch._int_mm beside it
            kind, shape, col = WGMMA_SHAPES[kname]
            tc = tc_rows[(kind, shape, col)]
            entry["wgmma"] = {"shape": f"{kind}{shape}",
                              **{key: tc[key] for key in (
                                  "device_ms", "tiled_device_ms",
                                  "library_device_ms", "plain_ms",
                                  "bound_ms", "host_us")}}
            case = next(c for c in paper_cases(floats=False)
                        if c[0] == WGMMA_SHAPES[kname][0])
            tc = gemm_rows[case]
            entry["wgmma_int"] = {"shape": f"{case[0]}{case[1]} {case[2]}",
                                  "kernel": "gemm_tc_int_kernel",
                                  **{key: tc.get(key) for key in (
                                      "device_ms", "gemm_ms", "prepass_ms",
                                      "tops", "tiled_ms", "library_ms",
                                      "library_col_ms", "col_ms", "plain_ms",
                                      "bound_ms")}}
        summary.append(entry)
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
