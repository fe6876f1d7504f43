#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card.  Run from the repository root with no arguments:

    python3 chip_smoke.py

(``python3 chip_smoke.py --mesh-bf16-spread`` prints instead the
readings the "train mesh" phase's (4, 2) bars are set from:
``mesh_bf16_spread``.)

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. card   — the device, and ``nvidia-smi``'s name and power limit;
2. build  — compile the CUDA kernels of ``src/repro_torch/kernels/csrc``;
3. kernels — every kernel of the served path against its plain PyTorch
   version on the card at the frontend's shapes (f32 with stated
   tolerances, int8 bit-exact), the fused kernel bitwise against its
   three-launch chain, and results independent of the tiling hints;
   the tiled ``conv2d_ip1`` and ``conv2d_ip2`` also at the ragged shapes
   of ``CONV_RAGGED`` (f32 and int8, any ``block_cout``, fused == chain
   for both styles); ``conv2d_ip4`` (``conv2d_ip2``'s tiled kernel with two
   streams) at ``CONV_RAGGED`` and both block shapes on f32, int8, int16
   and bf16, ``block_cout`` 1/5/16/128, one launch a call, integers exact
   and floats within ``rtol=1e-4, atol=1e-5`` of the plain version, f32
   and int8 streams bitwise equal to ``conv2d_ip2`` launches;
   ``conv2d_ip1`` and ``conv2d_ip2`` at ``CONV_RAGGED`` on bf16 and int16
   (``conv_dtype_checks``: one launch a call, int16 exact, bf16 within
   ``rtol=1e-4, atol=1e-5``, ``block_cout`` 1/5/16/128 bitwise, fused ==
   chain for both styles); the fused kernel (``fused_cnn_tiled_kernel``,
   both styles) at every ``CONV_RAGGED`` shape under the pool geometries
   of ``FUSED_GEOMS`` and the windows larger than a tile of
   ``FUSED_BIG``, max and avg, on f32, bf16, int16, native int8 and the
   int8 rung (``fused_geometry_checks``: one launch a call, == its
   three-launch chain bitwise but on the rung, integers and the rung
   bit-exact under relu (tanh within 1e-6) and floats within
   ``rtol=1e-4, atol=1e-5`` of the plain version, ``block_cout``
   1/5/16/128 bitwise); ``conv2d_ip3``
   (``conv2d_ip3_tiled_kernel``) at ``CONV_RAGGED`` and ``CONV3_TAIL``
   on full-range int8 (``conv3_checks``: one launch a call, bit-exact
   against the plain version and two ``conv2d_ip1`` launches,
   ``block_cout`` 1/5/16/128 bitwise); ``activation_exact`` (the vector
   kernel) on
   every dtype it takes at ``ACT_SHAPES``, its input at ``ACT_OFFSETS``
   bytes past a 16-byte boundary, every kind, one launch a call: equal
   to the plain version (relu/relu6 bitwise, bf16 within one bf16
   rounding) and, on f32, bitwise equal to the fused kernels'
   activation; the pools, the LUT and the activation on bf16
   (``bf16_elementwise_checks``: max pools and the LUT bitwise in bf16);
   both pools on ``pool_plan``'s cut (``pool2d_window``:
   ``pool2d_kernel``, ``pool2d_im2col``: ``pool2d_im2col_kernel``, one
   body) at the geometries of ``POOL_CHECKS`` on f32, bf16, int8 and
   int32, max and avg (``pool_geometry_checks``: one launch a call, max
   and integers bitwise, float avg within 1e-6 of the plain version on
   the card and bitwise equal to it on the CPU, ``pool2d_im2col``
   bitwise equal to ``pool2d_window``, 16-byte vectors exactly where C *
   itemsize is a multiple of 16 and the input aligned, a misaligned int8
   input included, NaN through max on the vector and the scalar path;
   both C entries refuse a bad dtype or mode, an oversized window, plans
   that do not cover the output and H * W * C past 32-bit index math,
   ``pool_refusal_checks``);
   ``activation_lut``
   on ``act_walk`` (``lut_walk_checks``: the launcher's split, queried
   by ``cnn_activation_plan``, equal to ``vpu_exact.walk_plan`` at byte
   offsets 0-15; bitwise equal to the plain version on every dtype at
   every aligned offset and numels 0, 1, 15, a tile +-1 and 40 tiles,
   one launch a call, NaN and +-inf on the end entries);
4. serve  — ``AdaptiveServer(device="cuda")`` with the default CNN
   frontend answers 8 seeded 224x224x3 requests through the fused plan
   (launch counters reset just before and read just after), a
   ``fuse=False`` server answers the same trace through the standalone
   kernels bitwise equal, and a ``device="cpu"`` server (plain versions)
   agrees within tolerance; the same for a bf16 and an int16 frontend
   (``FRONTEND_DTYPES``, ``serve_dtype_checks``): fused and unfused on the
   card, bitwise equal, within ``rtol=1e-4, atol=1e-5`` of the CPU
   server with equal accounting, int16's block 0 bitwise equal to the
   CPU's;
   Then the two precision-ladder deployments (``LADDER``): the LUT
   activation and the im2col pool against their plain versions
   bit-exact (NaN, +-inf and exact half-step ties included; the pool
   also bitwise equal to ``pool2d_window``); each
   deployment serves two tenants at 224x224x3 — a relu tenant in f32
   and a tanh tenant with ``ladder=(16, 8)`` and ``measure_quant`` that
   the arbiter squeezes onto lowered rungs — for 3 waves of 8 + 2
   requests, on the card (counters reset just before each and read just
   after) and on the CPU: the light tenant's plans are the expected
   ones, ``fused_cnn_mxu`` / ``activation_lut`` launched, the
   accounting equals the CPU server's and the results follow the
   code-flip rule (``code_flip``);
   Then "slo" (``slo_phase``, runtime/scheduler.py on the card): (a) the
   SLO deployment (``_slo_deployment`` at full width: ladder_fused's
   budget, ``slo_pressure=2.0``, ``grant_quantum=1/16``, the f32 relu
   "heavy" tenant at priority 0 and the tanh ``ladder=(16, 8)`` "light"
   one at priority 1) under an ``SLOScheduler`` on a wall that moves only
   when told, through a seeded trace of 16 heavy and 6 light requests
   with ``at=`` arrivals, a shed case (the wall moved past a queued
   bucket's deadline) and a rejection case (``max_queue_depth=2``
   overflowed), one launch at a time on the card (counters reset just
   before each and read just after: the kernels its plan names) and on
   the CPU: outcomes, ``stats()``, completions, the grants after each
   launch, miss rates and the ``tenant_``/``scheduler_`` lines of
   ``metrics().render()`` equal, at least one preemption, shed and
   rejection, heavy within ``rtol=1e-4, atol=1e-5`` and light under the
   code-flip rule; (b) ``benchmarks/run.py::table_slo``'s premise at
   full width: its 16x6 mix and constants in units of the card's warm
   batch-4 round (synchronized inside the timed region), the round loop
   (``AdaptiveServer.step``) against the scheduler (one launch a pump),
   warmup replays then ``SLO_REPLAYS`` measured, each synchronized
   before it stamps a completion: every request accounted for, the
   median worst-tenant deadline-normalized p95 and miss rate of each
   arm printed with sheds, preemptions and launches, and which arm wins
   logged, not checked; (c) ``flash_attention`` and ``flash_decode`` at
   head dims 8, 12 and 80 (zero-padded to the next kernel width) on f32
   and bf16, causal and full, GQA 8/2: one launch a call, within
   ``ATTN_F32_TOL`` / ``ATTN_BF16_TOL`` of the plain versions;
   ``attention(budget=)`` plans (1,4,64,8) x (1,2,64,8) and its
   one-token decode onto ``attn_flash`` / ``attn_decode`` and computes;
   Then "faults" (``faults_phase``: runtime/faults.py, guards.py,
   recovery.py and checkpoint/store.py on the card): (a) ladder_fused's
   deployment through the ladder trace disarmed, armed on a schedule
   that never fires and disarmed again: results, completions, grants and
   telemetry bitwise equal; (b) ``CHAOS_SCHEDULE`` (kernel exceptions,
   NaN outputs, latency spikes, a budget shrink; seeded) on the guarded
   deployment (``CHAOS_POLICIES``: heavy rejects a NaN, light retries it
   with the ladder off) on the card and on the CPU: completions, ``ok``
   flags, guard columns and ``fault.injected`` / ``retry.attempt`` /
   ``guard.rejected`` events equal, f32 results within ``rtol=1e-4,
   atol=1e-5`` and the light tenant under the code-flip rule; the
   availability of the guarded and of the bare arm logged (the bare arm
   serves fewer); a NaN on light under ``retry_f32`` launches exactly
   the kernels of its lowered plan and of the f32 retry's; a scheduled
   ``device_loss`` on one device serves (as the reference), a
   ``DeviceLost`` raised into the guard is rejected; (c) a guarded
   attempt that runs a wrapper on a misaligned CUDA view, or the C entry
   with an unknown dtype code, re-raises its ``ValueError`` /
   ``RuntimeError`` with no retry, event or launch; (d) a guarded
   deployment under an ``SLOScheduler``: ``snapshot_server``, a wave
   served, ``simulate_worker_death()``, ``recover_server(device=None)``:
   params on the card, zero cold plans over the restore and the same
   wave, which is bitwise the pre-crash server's; a bf16 tenant's params
   and batch bitwise; snapshot and recovery wall times (median of
   ``RECOVERY_REPS``), checkpoint bytes and plans imported logged; (e)
   ``RecoveryManager(heartbeat_timeout_s=HEARTBEAT_S)`` over the card's
   serving loop fires on silence, and again after ``recover()``; (f)
   ``flash_attention`` and ``flash_decode`` at head dims
   ``WIDE_HEAD_DIMS`` (144, 192, 256, 320: the 256- and 384-wide
   instances; bf16 one 128-column block of O a CTA; 400, 512, 1024: the
   chunked instances, D padded to a multiple of 128, S over D's chunks)
   on f32 and bf16, causal and full, GQA 4:1, ragged, decode included,
   one launch a call, within ``ATTN_F32_TOL`` / ``ATTN_BF16_TOL``;
   Then "calibration" (``calibration_phase``, core/calibrate_cost.py on
   the card): (a) both arms (fused, unfused) of ``CAL_NETWORKS`` x
   ``CAL_BATCHES`` x ``CAL_BUDGETS`` planned analytically (an infeasible
   arm printed ``x``), every distinct planned site (116) timed standalone
   by ``collect_plan_samples(device="cuda")`` and fitted: the JSON round
   trip bit-exact, a dedicated fit for every member key (12), every
   coefficient >= 0, the fits printed; (b) the reference's premise
   (``benchmarks/run.py::table_calibration``) at full width: each pair
   of feasible arms at batch 4 (11) timed end to end through
   ``apply_cnn_frontend(network=)`` in ``CAL_WINDOWS`` windows, the
   arms' calls interleaved; on every pair the stopwatch decides (one
   arm's median below the other's in every window; at least
   ``CAL_MIN_DECIDED``) the
   calibrated preference equals the measured one, and where it prefers
   unfused the calibrated plan has no fused site; (c) the sites whose
   member or rung the table moves, logged; (d) ``ladder_fused`` served
   by ``AdaptiveServer(calibration=table)`` on the card and the CPU:
   every batch's plan equal as JSON, accounting and grants equal, f32
   results within ``rtol=1e-4, atol=1e-5``, lowered ones under the
   code-flip rule, telemetry keyed on ``table.key()``, the variants that
   price by the global fit logged; (e) a ``DriftMonitor`` on the table
   over fresh batch-4 site times (its mean relative error logged), and
   on the table mis-scaled by ``CAL_MISSCALE``: one flag, and
   ``recalibrate()`` moves the fingerprint and re-arms it; (f)
   ``AdaptiveServer(autotune=True)`` bitwise equal to ``autotune=False``
   on the 8 requests, the overridden sites logged;
   and ``pool2d(budget=)`` picks and launches the im2col pool;
   Then "mesh" (``mesh_phase``: core/shard.py, distributed/, the mesh
   paths of the arbiter and the server, on ``MESH_DEVICES`` logical
   devices that share the card, asked for by name): (a)
   ``apply_plan_sharded`` at both full-width blocks, a batch split
   (fused and unfused) bitwise equal to ``apply_plan_replicated`` with
   each sharded site's kernel launched once a shard, block 1's conv
   split by input channel (8 of 16 a device) on ``ip1_vpu`` and
   ``ip2_mxu``, psum and ring, within ``MESH_TOL`` of the replicated walk
   and ring within it of psum, a lowered plan refused with the
   reference's message; (b) ``AdaptiveServer(mesh=MeshSpec(devices=2),
   devices=(cuda:0,) * 2)`` serves the default frontend at full width
   under ``MESH_BUDGET``: the plan's JSON hashes to ``MESH_PLAN_SHA``
   (the reference's plan), each batch launches both fused kernels once
   a shard, completions within ``rtol=1e-4, atol=1e-5`` of the CPU
   port's mesh server with equal accounting; (c) the reference's
   ``test_server_survives_device_loss_end_to_end`` at full width:
   ``prewarm_spares(losses=1)`` then a ``device_loss`` fault mid-wave,
   every completion ``ok``, the mesh shrunk to one device, 0 cold plans,
   ``shard_degree_mix`` keys [1, 2], ``precision_mix`` {32}; (d) served
   requests/s of the mesh tenant and of the same tenant unsharded in
   alternating windows, logged;
   Then "dual and matmul": ``conv2d_dual(budget=)`` on two seeded
   batches of 4 at both frontend block shapes under the four budgets of
   ``DUAL_PLANS`` (Conv3 and Conv4 on int8, f32 and int16, integers over
   their full range), and ``matmul`` / ``int8_matmul(use_kernel=True)``
   at Llama-3.2-1B's FFN up-projection (``FFN``) under the budgets of
   ``MATMUL_PLANS`` (``mm_mxu``, ``mm_vpu`` and the lowered rungs through
   ``quantized_matmul``): each call plans onto the listed member and
   launches its kernel exactly once (counters reset just before, read
   just after); integers bit-exact against the plain versions (int8
   Conv3/Conv4 also against two ``conv2d_ip1`` launches), f32 Conv4
   bitwise equal to two ``conv2d_ip2`` launches, f32 matmuls within
   ``rtol=2e-4, atol=1e-3``, results independent of the tiling hints;
   Then "lm sites": the budget sweep's four LM sites
   (``lm_network_specs``, the port's copy of
   ``examples/budget_sweep.py``'s at Llama-3.2-1B's widths) planned
   under its six budgets must give the reference's table (``LM_TABLE``);
   each of its distinct (site, member, bits) runs once on numpy-seeded
   operands through its op wrapper (``conv2d``, ``conv2d_dual``,
   ``matmul``, ``matmul_dual``, ``quantized_matmul``, ``attention``)
   and launches its member's kernel exactly once; integers bit-exact,
   bf16 matmuls within ``MM_TOL``, bf16 attention within
   ``ATTN_BF16_TOL`` against the plain versions run a slice at a time;
   ``attention(budget=ResourceBudget(mxu_available=False))`` raises "no
   feasible IP"; f32 attention and decode within ``ATTN_F32_TOL``
   (``ATTN_F32_CASES``, ``DECODE_F32_CASES`` and the two sites' full
   shapes; rows that see no key are 0); split-KV decode at
   ``DECODE_SPLIT_CASES`` in bf16 and f32 (one launch a call; the splits
   and resident CTAs the launcher chose at attn_decode32k logged); bf16
   flash attention (the tensor-core kernel,
   ``csrc/attn_tc_kernels.cu``) within ``ATTN_BF16_TOL`` at
   ``ATTN_BF16_CASES``, rows that see no key 0; ``matmul_dual`` on bf16
   plans and launches
   ``mm_dual_full``, which equals two ``mm_mxu`` launches bitwise (bf16,
   f32); the tensor-core route (int8 and bf16 ``mm_mxu`` / ``_mm_dual``,
   ``csrc/mm_tc_kernels.cu``) at the ragged shapes of ``TC_RAGGED``
   against the plain versions (int8 bit-exact, bf16 within ``MM_TOL``),
   each dual stream bitwise equal to an ``mm_mxu`` launch; f32 ``mm_mxu``
   (``mm_mxu_f32_kernel``) at ``TC_RAGGED`` within ``MM_TOL`` and
   bitwise equal to ``mm_vpu``; f32 ``mm_dual_full``
   (``mm_dual_f32_kernel``, ``mm_mxu``'s body with two streams) at
   ``TC_RAGGED`` and, planned by ``matmul_dual(budget=)``, at the sweep's
   FFN: one launch, each stream bitwise equal to ``mm_mxu``;
   and ``cuobjdump -sass`` shows no MMA instruction in the logic-only
   kernels (``LOGIC_ONLY``: the activations and ``pool2d_kernel`` too)
   and in the MXU members' CUDA-core kernels (``CUDA_CORE``:
   ``pool2d_im2col_kernel``, f32 ``flash_attention_kernel``),
   IGMMA in the int8 and HGMMA in the bf16
   tensor-core kernels, bf16 flash attention's included (``TC_SASS``;
   its 256- and 384-wide instances, and the f32 kernel's, present:
   ``WIDE_SASS``),
   and every kernel of the ``kernels`` line (``KERNEL``) in the library;
5. times  — the floor of ``time_ms`` (``zero_()`` on a 1-element
   tensor), and per kernel (``pool2d_window`` also at a batch-64 block 0
   and at 3x3 windows of stride 1 and 2, ``pool2d_im2col`` also at the
   batch-64 block 0, ``activation_lut`` also on 256
   images, ``conv2d_ip1`` also
   at block 1 and on int8 at
   block 0, ``conv2d_ip2`` also on int8 and bf16 at block 1 (bf16
   ``F.conv2d`` beside it), the fused blocks also on bf16 (each fused
   row with its three-launch chain timed beside it, and its grid: CTAs,
   registers, CTAs an SM and waves; Conv3's row with two ``conv2d_ip1``
   launches and its grid),
   ``flash_attention`` (its f32 output at attn_train4k also held to
   ``ATTN_F32_TOL`` head chunk by head chunk; bf16 and f32 again at
   head dim 256, ``WIDE_TRAIN``), ``flash_decode`` at head dim 256
   (``WIDE_DECODE``; SDPA at the same D beside both),
   ``flash_decode`` (with f32 SDPA beside it, or the error it raises)
   and ``mm_dual_full`` also on f32; ``mm_mxu`` per
   operand dtype:
   f32 on CUDA cores, int8 and bf16 on the tensor cores; ``mm_vpu`` per
   operand dtype, all on CUDA cores): the median device time of 20
   launches (CUDA
   events, launches queued ahead of the device), its plain version's
   and the PyTorch library call's time, and the least time the card
   could take (bytes over peak bandwidth, or operations over the peak
   rate of their type: FP32, bf16 or int8 tensor-core, or INT32 lanes,
   and for flash attention the exponentials at the MUFU rate too;
   the new kernels of "lm sites" at the sites' shapes, their chunked
   plain versions timed call by call, ``time_sync_ms``);
   then the served requests per second over 3 steady windows (rounds of
   the 8-request trace, >= 512 requests and about 1 s each), and one
   more such window under ``torch.profiler``: device time by kernel and
   the device's busy share; then each ladder deployment's served rate
   over 3 windows of rounds of its trace (>= 1 s each), and
   ``ladder_fused``'s again with the calibration phase's table;
6. lm serve — ``jamba_period`` (Jamba-1.5-Large at full width, one
   period of its stack: 8 layers, MoE off; bf16) serves ``LM_TRACE``
   through ``repro_torch.launch.serve.serve_requests``: every request
   completes with its tokens, the trace launches ``selective_scan``
   exactly 7 times a prefill and nothing else (counters reset just
   before, read just after), a second serve gives the same tokens;
   ``selective_scan`` bitwise equal to its plain version (the kernel's
   y-sum order) and within tolerance of the family oracle
   ``selective_scan_ref`` (torch's own sum over the states) on the
   first Mamba layer's own operands (atol 1e-4 of each output's RMS),
   on the reference test's data at full width and at small cases
   (``SCAN_TOL``), at the d_states of ``SCAN_DS_CASES`` (1, 5, 32, 300;
   32 also at full width), one launch a call, independent of
   ``block_di``; at full width the kernel's and the oracle's y are
   also measured against the recurrence in f64 (``scan_f64``); once
   through the library entry; a full-width f32 Mamba layer's prefill
   against 64 decode steps (``SEQ_TOL``); the f32 one-period model's
   first decode step against a prefill over prompt + token
   (``HANDOFF_REL_L2``, same argmax); the scan's time, plain time and
   bound (bytes, FP32 operations and exponentials at the MUFU rate),
   tokens/s over the trace, prefill and decode-tick times, and a
   ``torch.profiler`` pass over one prefill and one decode tick.
7. lm families (``lm_families_phase``) — the other LM families at full
   width, each freed before the next: dbrx cut to ``DBRX_LAYERS`` layers
   (bf16, MoE on, einsum dispatch) serves ``LM_TRACE``, rwkv6-3b whole
   serves ``RWKV_TRACE``, through ``serve_requests`` twice (every request
   completes, the same tokens, no kernel launched); llava cut to
   ``LLAVA_LAYERS`` layers prefills ``LLAVA_CASE``'s seeded embeddings
   and decodes seeded embeddings, seamless whole prefills
   ``SEAMLESS_CASE``'s frames and decoder prompt and decodes greedily,
   twice each (the same greedy tokens); prefill ms, decode ms a tick
   beside its weight-read bound, tokens/s and peak memory for each, and
   a ``torch.profiler`` pass over one decode tick of each (dbrx's top 8
   device ops, the others' top 3; device busy against the tick's
   wall); dbrx's first
   prefill under the scatter dispatch within ``DISPATCH_REL_L2`` of
   einsum's, both timed (check 4); every architecture's smoke config in
   f32 on the card against the port on the CPU (``FAMILY_TOL``, prefill
   and two decode steps, logits and caches; served tokens equal for the
   token-in ones; jamba with and without MoE, each MoE arch under both
   dispatch modes; check 2); rwkv, llava and seamless in f32 at full
   width cut to ``SEQ_FAMILY_LAYERS`` layers, a prefill over S + 1
   positions against a prefill over S and one decode step
   (``HANDOFF_REL_L2``, check 3).
8. train (``train_phase``) — training on one card: (a) the forward
   that saves states (``selective_scan_fwd``: y and h, which training
   returns) bitwise equal to its plain version and to serving's
   ``selective_scan`` at the cases below, and the selective
   scan's backward (``selective_scan_bwd``, one launch of
   ``selective_scan_bwd_kernel`` and its two reductions) bitwise equal to
   its plain version and to a second launch on the same operands at
   ``SCAN_SITE``, ``SCAN_FULL_CASES``, ``SCAN_SMALL_CASES`` and
   ``SCAN_DS_CASES`` with ``dh`` given and ``None``, at full width
   within ``BWD_F64_TOL`` of the recurrence's gradient in f64; its time,
   plain time and bound at ``SCAN_BWD_TIMED``, beside the forward's with
   and without saving states; (b) every smoke config of
   ``smoke_families`` takes one ``api.train_step`` on the card and on
   the CPU (loss, grad_norm and grads within ``FAMILY_TOL``, params
   within the CPU tests' bar; only jamba launches kernels); (c) llama3.2-1b whole through
   ``repro_torch.launch.train`` (``TRAIN_LLAMA_ARGS``, one final
   checkpoint in a temporary directory, removed): losses finite and
   falling, step ms, tokens/s, save time, peak memory; (d) the main
   path: ``jamba_period`` in bf16 takes ``TRAIN_JAMBA``'s steps, the
   counters showing 14 forward and 7 backward scans a step and nothing
   else, step ms, tokens/s, peak memory and one profiled step; (e) the
   reference integration test's resume case (exit code 17, "resuming
   at 17", final loss within ``RESUME_TOL`` of the gold run).
9. train mesh (``train_mesh_phase``) — training on a ("data", "model")
   mesh of logical devices of the one card (``logical(n)``): (a)
   llama3.2-1b whole through ``launch/train.py::build`` with (c)'s
   optimizer, data and seed: a (1, 2) mesh's first step in f32, its
   two model ranks splitting attention, FFN and vocabulary, bitwise the
   same split run on one device and within ``METRIC_TOL`` and the CPU
   tests' grad and param bars of the single-device step
   (``mesh_split_checks``); three single-device steps (a fourth
   profiled); the (4, 2) state's first step bitwise the same split on
   one device (``mesh_bitwise_check``), three (4, 2) steps within
   ``mesh_bar_misses``' bars of the single-device steps (step ms, peak
   memory, one profiled step), and last a control, the same steps with
   a wrong split (``mesh_fault("kv_swap")``), which must miss them; (d)
   that state saved, restored under ``elastic_remesh(6,
   prefer_model=2)``'s (3, 2) mesh bitwise (save and restore seconds),
   one (3, 2) step; an (8, 1) step with ``fsdp=True`` (its 4 rows run
   whole: bitwise the single-device first step); (e) train's run (c),
   through the (1, 1) mesh, has the single-device steps' losses; (b)
   every config of ``smoke_families`` takes one (4, 2) step at (8, 32)
   on the card and on the CPU (``FAMILY_TOL``; jamba launches the scan's
   forward and backward on each (data, model) rank, on its data rank's
   rows and its d_inner / 2 channels, nothing else launches; the MoE
   configs' 4 experts split by expert, 2 a model rank; rwkv's mixes and
   seamless's cross-attention split too), and ``MESH_HIDDEN``,
   grok-1-314b smoke on (1, 8), whose 4 experts do not divide 8, splits
   each expert's hidden columns (16 of 128 a rank), on the card and on
   the CPU within ``FAMILY_TOL``, with no param all-gathered over
   "model"; ``MESH_RWKV``, rwkv6-3b smoke on (1, 8), whose 4 heads do
   not divide 8 (ranks 1, 3, 5, 7 own one head, each taking the half
   head another rank stores: collective-permutes of exactly those
   bytes, nothing all-gathered), loss and xent within ``FAMILY_TOL``,
   params within 2 lr; (c) ``gpipe_forward`` over 4 logical
   stages of 4 llama blocks in bf16, 8 microbatches of (1, 1024),
   bitwise the 16 blocks in sequence, both timed.

10. dryrun and examples (``dryrun_examples_phases``) — "dryrun" (a):
   ``DRYRUN_CELLS`` through ``python -m repro_torch.launch.dryrun`` on
   meta at full production size (olmo-1b train_4k single calibrated,
   jamba decode_32k single, grok-1-314b train_4k multi, rwkv6-3b and
   seamless-m4t-large-v2 decode_32k single, jamba long_500k and
   llava-next-34b decode_32k single), one process a
   cell started together on the CPU before "train mesh" (9.), running
   beside it and "examples": every
   ``examples_torch/*.py`` with its defaults on the card,
   ``EXAMPLES_AT_ONCE`` at a time (exit 0, its own checks, wall
   seconds); then (a)'s records (``ok``, ``DRYRUN_STATIC``, olmo's
   extrapolated FLOPs and collective bytes equal to the full count,
   static and temp GiB a device against 80 GiB, the roofline at the
   H100's rates); (b) ``GROUND_CASES``: the dry-run's counters
   (``dryrun.count_step``) around one sharded train step on a (2, 2)
   mesh, on meta and on logical devices of the card, FLOPs, bytes,
   collective bytes and kernels equal rank by rank (jamba launches the
   scan on each of the 4 ranks through its count hook, and splits its
   MoE by expert; llama again with ``fsdp=True``: each layer group's
   blocks all-gathered over "data" as the group runs, forward and
   recompute, and its gradient reduce-scattered onto the blocks, and
   the card's peak within 5% of the record's), the card's peak memory
   against the record's, the synchronized step against
   ``bound_time_s``; and ``GROUND_DECODES``, smoke configs' serving
   decode steps on (2, 4): jamba's of 16 rows, whose 2 kv heads do not
   divide 4, so each model rank holds and attends over its sequence
   block of the cache, and of 1 row, its cache's sequence split over
   ("data", "model") into 8 blocks, each attended where it lies;
   seamless's, its frozen cross-attention cache split by kv head;
   rwkv's, its heads split and its state whole; a llava whose 6 query
   and 2 kv heads do not divide 4, its attention whole on the first
   model rank over a cache split by sequence: counts equal on meta and
   on the card rank by rank, the logits within ``FAMILY_TOL`` of the
   unsplit ``decode_step`` on the card, a split cache never gathered;
   (c) ``launch/report.py`` renders (a)-(b)'s records
   (in ``experiments/dryrun_torch_smoke``) with no ``ERROR`` row.

Output: the ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi --query-gpu=name,power.limit`` line, and as the last line
``{"ok": true, "device": {...}}``.  Float32 convolutions in the library
yardstick run with ``torch.backends.cudnn.allow_tf32 = False`` and
matmuls with ``torch.backends.cuda.matmul.allow_tf32 = False`` (full
IEEE float32, as the port computes).
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CSRC = "src/repro_torch/kernels/csrc/cnn_kernels.cu"
CSRC_MM = "src/repro_torch/kernels/csrc/mm_kernels.cu"
CSRC_MM_TC = "src/repro_torch/kernels/csrc/mm_tc_kernels.cu"
CSRC_ATTN = "src/repro_torch/kernels/csrc/attn_kernels.cu"
CSRC_ATTN_TC = "src/repro_torch/kernels/csrc/attn_tc_kernels.cu"
CSRC_SCAN = "src/repro_torch/kernels/csrc/scan_kernels.cu"
SEED = 0
N_REQUESTS = 8
MAX_BATCH = 4
IMAGE = (224, 224, 3)
REPS = 20
# The served rate's window: rounds of the N_REQUESTS trace, at least this
# many requests and about this many seconds; timed RATE_WINDOWS times.
RATE_MIN_REQUESTS = 512
RATE_WINDOW_S = 1.0
RATE_WINDOWS = 3

# Peak rates of the card, by the NVIDIA H100 data sheet (dense, without
# sparsity): device-memory bandwidth in bytes/s, FP32 CUDA-core FLOP/s
# and int8 tensor-core OP/s.  The INT32 CUDA-core rate is not on the
# data sheet: Hopper has 64 INT32 lanes per SM (the H100 architecture
# white paper), at the clock the data sheet's FP32 rate implies
# (67e12 / (132 SMs x 128 FP32 lanes x 2) = 1.98 GHz on the SXM part,
# 51e12 / (114 x 128 x 2) = 1.75 GHz on the PCIe part), counting a
# multiply-add as 2 operations as the FP32 rate does: 132 x 64 x 2 x
# 1.98e9 = 33.5e12.  The rates assume the card's full power limit.
# bf16 dense tensor-core FLOP/s are the data sheet's too (989.4e12 SXM,
# 756e12 PCIe): the bound of bf16 attention and bf16 matmuls, whatever
# units the kernels run on.  The exponential rate is the multi-function
# units': 16 results per clock per SM for compute capability 9.0 (the
# CUDA C++ Programming Guide's arithmetic-instruction throughput table),
# at the same clocks: 16 x 132 x 1.98e9 = 4.18e12/s (SXM), 16 x 114 x
# 1.75e9 = 3.19e12/s (PCIe).
PEAKS = {
    "H100 SXM": {"bytes_per_s": 3.35e12, "fp32_flops": 67e12,
                 "bf16_tensor_flops": 989.4e12,
                 "int8_tensor_ops": 1979e12, "int32_ops": 33.5e12,
                 "mufu_per_s": 16 * 132 * 1.98e9},
    "H100 PCIe": {"bytes_per_s": 2.0e12, "fp32_flops": 51e12,
                  "bf16_tensor_flops": 756e12,
                  "int8_tensor_ops": 1513e12, "int32_ops": 25.5e12,
                  "mufu_per_s": 16 * 114 * 1.75e9},
}

# file:line of the TPU kernel each CUDA kernel replaces (the function
# that reaches pl.pallas_call).
REPLACES = {
    "activation_lut": "src/repro/kernels/activation/lut_poly.py:56",
    "pool2d_im2col": "src/repro/kernels/pool2d/mxu_im2col.py:53",
    "fused_cnn_vpu": "src/repro/kernels/fused/cnn_block.py:86",
    "fused_cnn_mxu": "src/repro/kernels/fused/cnn_block.py:86",
    "conv2d_ip1": "src/repro/kernels/conv2d/ip1_vpu.py:35",
    "conv2d_ip2": "src/repro/kernels/conv2d/ip2_mxu.py:30",
    "pool2d_window": "src/repro/kernels/pool2d/vpu_window.py:62",
    "activation_exact": "src/repro/kernels/activation/vpu_exact.py:35",
    "conv2d_ip3": "src/repro/kernels/conv2d/ip3_packed.py:62",
    "conv2d_ip4": "src/repro/kernels/conv2d/ip4_dual.py:48",
    "mm_mxu": "src/repro/kernels/matmul/mxu.py:52",
    "mm_mxu (int8)": "src/repro/kernels/matmul/mxu.py:52",
    "mm_mxu (bf16)": "src/repro/kernels/matmul/mxu.py:52",
    "mm_vpu": "src/repro/kernels/matmul/mxu.py:89",
    "mm_vpu (int8)": "src/repro/kernels/matmul/mxu.py:89",
    "mm_vpu (bf16)": "src/repro/kernels/matmul/mxu.py:89",
    "mm_dual_shared": "src/repro/kernels/matmul/dual.py:44",
    "mm_dual_full": "src/repro/kernels/matmul/dual.py:44",
    "mm_dual_full (f32)": "src/repro/kernels/matmul/dual.py:44",
    "flash_attention": "src/repro/kernels/attention/flash.py:77",
    "flash_decode": "src/repro/kernels/attention/decode.py:58",
    "flash_attention (D 256)": "src/repro/kernels/attention/flash.py:77",
    "flash_decode (D 256)": "src/repro/kernels/attention/decode.py:58",
    "flash_attention (D 512)": "src/repro/kernels/attention/flash.py:77",
    "flash_decode (D 512)": "src/repro/kernels/attention/decode.py:58",
    "selective_scan": "src/repro/kernels/mamba_scan/scan.py:54",
    # no TPU kernel: the reference takes jax.grad of the lax.scan here
    "selective_scan_bwd": "src/repro/models/mamba.py:86",
}
# The rows of the kernels line that run on the tensor cores: mm_mxu on
# int8 and bf16 operands ("mm_mxu (int8)", "mm_mxu (bf16)"; its f32 row
# "mm_mxu" stays on CUDA cores) and the dual rows, timed on int8 and bf16
# (the f32 dual row, "mm_dual_full (f32)", stays on CUDA cores);
# flash_attention, timed on bf16 (attn_tc_kernels.cu; f32 stays on
# attn_kernels.cu's CUDA-core kernel), at head dim 64 and, its 256-wide
# instances ("faults" (f)), 256.
TC_ROWS = ("mm_mxu (int8)", "mm_mxu (bf16)", "mm_dual_shared", "mm_dual_full")
SOURCE = {name: (CSRC_MM_TC if name in TC_ROWS else
                 CSRC_MM if name.startswith("mm_") else
                 CSRC_ATTN_TC if name.startswith("flash_attention") else
                 CSRC_ATTN if name.startswith("flash_") else
                 CSRC_SCAN if name.startswith("selective_scan") else CSRC)
          for name in REPLACES}
# The CUDA kernel (__global__ function) behind each row of the kernels
# line, as the row is timed: mm_mxu on f32 runs the CUDA-core kernel,
# the dual rows their int8 / bf16 tensor-core kernels and f32
# mm_dual_full mm_mxu's CUDA-core body with two streams; conv2d_ip4 runs
# conv2d_ip2's tiled kernel with two streams; flash_decode is one launch
# of two kernels.
KERNEL = {
    "activation_lut": "activation_lut_kernel",
    "pool2d_im2col": "pool2d_im2col_kernel",
    "fused_cnn_vpu": "fused_cnn_tiled_kernel",
    "fused_cnn_mxu": "fused_cnn_tiled_kernel",
    "conv2d_ip1": "conv2d_vpu_tiled_kernel",
    "conv2d_ip2": "conv2d_mxu_tiled_kernel",
    "pool2d_window": "pool2d_kernel",
    "activation_exact": "activation_kernel",
    "conv2d_ip3": "conv2d_ip3_tiled_kernel",
    "conv2d_ip4": "conv2d_mxu_tiled_kernel",
    "mm_mxu": "mm_mxu_f32_kernel",
    "mm_mxu (int8)": "mm_tc_mxu_i8_kernel",
    "mm_mxu (bf16)": "mm_tc_mxu_bf16_kernel",
    "mm_vpu": "mm_vpu_kernel",
    "mm_vpu (int8)": "mm_vpu_kernel",
    "mm_vpu (bf16)": "mm_vpu_kernel",
    "mm_dual_shared": "mm_tc_dual_i8_kernel",
    "mm_dual_full": "mm_tc_dual_bf16_kernel",
    "mm_dual_full (f32)": "mm_dual_f32_kernel",
    "flash_attention": "attn_tc_flash_kernel",
    "flash_decode": "flash_decode_split_kernel, decode_combine_kernel",
    "flash_attention (D 256)": "attn_tc_flash_kernel",
    "flash_decode (D 256)": "flash_decode_split_kernel, decode_combine_kernel",
    "flash_attention (D 512)": "attn_tc_flash_kernel",
    "flash_decode (D 512)": "flash_decode_split_kernel, decode_combine_kernel",
    "selective_scan": "selective_scan_kernel",
    "selective_scan_bwd": "selective_scan_bwd_kernel, "
                          "scan_bwd_reduce_bc_kernel, "
                          "scan_bwd_reduce_a_kernel",
}
# Kernels of logic-only members (mxu_available=False, or uses_mxu=False
# as ssm_scan.selective_vmem): no MMA in SASS.
LOGIC_ONLY = ("conv2d_vpu_tiled_kernel", "conv2d_ip3_tiled_kernel",
              "fused_cnn_tiled_kernel", "mm_vpu_kernel",
              "selective_scan_kernel", "selective_scan_bwd_kernel",
              "scan_bwd_reduce_bc_kernel", "scan_bwd_reduce_a_kernel",
              "activation_kernel", "activation_lut_kernel", "pool2d_kernel")
# Kernels of MXU members that run on CUDA cores on this card: the im2col
# pool (the window pool's body) and f32 flash attention (no IEEE-f32
# MMA; TF32 would miss ATTN_F32_TOL).  No MMA in SASS either.
CUDA_CORE = ("pool2d_im2col_kernel", "flash_attention_kernel")
MMA_SASS = ("HMMA", "IMMA", "HGMMA", "IGMMA")
# The attention instances past head dim 128 (mangled names): each must
# be in the library, under the checks of TC_SASS and CUDA_CORE.
WIDE_SASS = ("attn_tc_flash_kernelILi256ELi128E",
             "attn_tc_flash_kernelILi384ELi128E",
             "attn_tc_flash_kernelILi0ELi128E",
             "flash_attention_kernelILi256E",
             "flash_attention_kernelILi384E",
             "flash_attention_kernelILi0E",
             "flash_decode_split_kernelIfLi0E",
             "flash_decode_split_kernelI13__nv_bfloat16Li0E")
# The tensor-core kernels by source, and the wgmma instruction each must
# contain (and no other MMA kind): the MXU matmul members and bf16 flash
# attention.
TC_SASS = {CSRC_MM_TC: {"mm_tc_mxu_i8_kernel": "IGMMA",
                        "mm_tc_dual_i8_kernel": "IGMMA",
                        "mm_tc_mxu_bf16_kernel": "HGMMA",
                        "mm_tc_dual_bf16_kernel": "HGMMA"},
           CSRC_ATTN_TC: {"attn_tc_flash_kernel": "HGMMA"}}

# The dual-stream conv calls at each frontend block shape: operand dtype,
# budget, and the member the planner gives (the reference's planner
# gives the same).
DUAL_PLANS = (
    ("int8", dict(precision_bits=8, mxu_passes_budget=1),
     "conv2d.ip3_packed"),
    ("int8", {}, "conv2d.ip4_dual"),
    ("float32", {}, "conv2d.ip4_dual"),
    ("int16", dict(precision_bits=16), "conv2d.ip4_dual"),
)
# Llama-3.2-1B's FFN up-projection (src/repro/configs/llama3_2_1b.py:
# d_model 2048, d_ff 8192) over 512 tokens: (M, K, N).
FFN = (512, 2048, 8192)
# matmul(a, b, ladder=, budget=) at FFN: operand dtype, ladder, budget,
# the planned member@bits (the reference's planner gives the same), and
# the kernel it launches.
MATMUL_PLANS = (
    ("float32", (), {}, "matmul.mm_mxu@32", "mm_mxu"),
    ("int8", (), {}, "matmul.mm_mxu@8", "mm_mxu"),
    ("float32", (), dict(mxu_available=False), "matmul.mm_vpu@32",
     "mm_vpu"),
    ("float32", (8,), dict(vmem_bytes=1 << 20), "matmul.mm_mxu@8",
     "mm_mxu"),
    ("float32", (16, 8), dict(vmem_bytes=900 * 1024), "matmul.mm_vpu@16",
     "mm_vpu"),
)
# f32 matmul tolerance at K=2048 with unit-normal operands: the kernels
# sum each output in one sequential FMA chain, cuBLAS in another order.
MM_TOL = dict(rtol=2e-4, atol=1e-3)
# (M, K, N) of the tensor-core route's ragged cases: M, N no multiple of
# the 128 x 256 CTA tile, int8 K and N no multiple of 16 bytes (the
# wrapper pads them), bf16 K and N padded too in the second case
TC_RAGGED = ((300, 1000, 520), (1, 17, 3), (130, 72, 1000))


def mm_row(kernel, dtype):
    """The row of the kernels line that a launch of ``kernel`` on
    ``dtype`` operands counts under: ``mm_mxu`` on int8 or bf16 runs the
    tensor-core kernels, on f32 the CUDA-core one; ``mm_vpu`` has a row
    per operand dtype."""
    import torch
    if (kernel in ("mm_mxu", "mm_vpu")
            and dtype in (torch.int8, torch.bfloat16)):
        return f"{kernel} ({'int8' if dtype == torch.int8 else 'bf16'})"
    return kernel


# The budget sweep's LM sites (examples/budget_sweep.py:38-54) at
# Llama-3.2-1B's widths (src/repro/configs/llama3_2_1b.py:10-11: d_model
# 2048, 32 heads, 8 kv heads, head_dim 64, d_ff 8192), under the sweep's
# six budgets (examples/budget_sweep.py:27-35).
LLAMA = dict(d_model=2048, d_ff=8192, n_heads=32, n_kv_heads=8,
             head_dim=64)
LM_BUDGETS = {
    "ample": {},
    "no_mxu": dict(mxu_available=False),
    "vmem_16MiB": dict(vmem_bytes=16 * 2**20),
    "vmem_6MiB": dict(vmem_bytes=6 * 2**20),
    "int8_parallel": dict(precision_bits=8, prefer_parallel_streams=True),
    "int8_serial": dict(precision_bits=8),
}
# The reference's plan of those sites (examples/budget_sweep.py prints
# it): member@bits, '*' where the precision ladder lowered the site, '!'
# where no joint plan exists and the site fell back to select_ip.
LM_TABLE = {
    "ample": ("ip1_vpu@8b", "mm_mxu@16b", "attn_flash@16b",
              "attn_decode@16b"),
    "no_mxu": ("ip1_vpu!", "mm_vpu!", "infeasible", "infeasible"),
    "vmem_16MiB": ("ip1_vpu@8b", "mm_mxu@16b", "attn_flash@16b",
                   "attn_decode@16b"),
    "vmem_6MiB": ("ip1_vpu@8b", "mm_vpu@8b*", "attn_flash@16b",
                  "attn_decode@16b"),
    "int8_parallel": ("ip3_packed@8b", "mm_dual_shared@8b",
                      "attn_flash@16b", "attn_decode@16b"),
    "int8_serial": ("ip1_vpu@8b", "mm_mxu@8b", "attn_flash@16b",
                    "attn_decode@16b"),
}
# the kernel each planned member launches
MEMBER_KERNEL = {"ip1_vpu": "conv2d_ip1", "ip3_packed": "conv2d_ip3",
                 "mm_mxu": "mm_mxu", "mm_vpu": "mm_vpu",
                 "mm_dual_shared": "mm_dual_shared",
                 "attn_flash": "flash_attention",
                 "attn_decode": "flash_decode"}
# Attention tolerances against the plain versions.  bf16: the plain
# version computes in f32 from the bf16 operands and rounds once to bf16.
# Decode does the same; flash runs Q.K^T on the tensor cores into f32 and
# P.V with P split in two bf16 terms (P_hi = bf16(P), P_lo = bf16(P -
# P_hi), P kept to about 2^-17 of its value), so the two differ by about
# one bf16 ulp of the output (at most 2^-7 of the value, inside rtol).
# P rounded once to bf16 would miss this bound; the split, emulated on
# the CPU (tests/test_torch_attention.py::
# test_flash_split_p_emulation_holds_the_bound), and measured on the card
# at attn_train4k, stays inside it.  atol lies far below the outputs'
# scale (about 9e-3 at attn_decode32k, 3e-2 at attn_train4k), so a zero,
# mis-scaled or partly summed output fails.  It is inside the reference
# test's bf16 bound, rtol=atol=5e-2 (tests/test_kernels_attention.py:
# 53-55).  f32: the reference test's f32 bound (:27-28).
ATTN_BF16_TOL = dict(rtol=1e-2, atol=1e-4)
ATTN_F32_TOL = dict(rtol=2e-4, atol=2e-5)
# f32 attention checks at Llama's head layout (group 4, head_dim 64):
# (B, Hq, Hkv, Sq, Skv, D); a length that is no multiple of a block, a
# cached prefill (Skv > Sq), and rows that see no key (Sq > Skv); then
# the reference test's CASES (other head dims).
ATTN_F32_CASES = ((2, 8, 2, 1000, 1000, 64), (2, 8, 2, 256, 1280, 64),
                  (1, 8, 2, 300, 100, 64), (1, 4, 4, 32, 32, 16),
                  (2, 8, 2, 64, 64, 32), (1, 8, 1, 60, 60, 16),
                  (2, 4, 4, 48, 96, 32), (1, 8, 2, 200, 200, 128))
# bf16 flash checks (the tensor-core kernel): the f32 cases' shapes,
# causal and full, rows that see no key 0
ATTN_BF16_CASES = ATTN_F32_CASES
# f32 decode checks: (B, Hq, Hkv, Skv, D)
DECODE_F32_CASES = ((4, 32, 8, 4097, 64), (2, 8, 2, 257, 32),
                    (2, 2, 2, 17, 16), (2, 16, 2, 300, 128))
# split-KV decode checks, bf16 and f32: (B, Hq, Hkv, Skv, D).  A single
# key, lengths no multiple of a stage, long caches at a batch small
# enough that the launcher splits them into many chunks (the last one
# short), GQA groups 1, 4 and 8, a group of 12 (two row blocks, the
# second half full) and one of 256 (32 row blocks)
DECODE_SPLIT_CASES = ((1, 2, 2, 1, 64), (1, 8, 2, 17, 64),
                      (1, 16, 2, 257, 64), (1, 8, 2, 4097, 64),
                      (2, 2, 2, 4097, 128), (1, 16, 2, 4097, 32),
                      (1, 24, 2, 300, 128), (1, 256, 1, 17, 128))
# conv2d_ip1's ragged checks (x, w): rows and columns no multiple of the
# tile, Cout 7 (no 16-byte stores) and 40 (two channel blocks, the second
# ragged), Cin 1, 3 on rows no multiple of 16 bytes (element copies), 5
# and 600 (staged in chunks), 8 (block 1's input channels split over the
# mesh's two devices, "mesh" (a)), 1x1, 3x3 and 5x5 taps
CONV_RAGGED = (((2, 13, 37, 1), (3, 3, 1, 7)),
               ((1, 11, 19, 5), (5, 5, 5, 7)),
               ((2, 9, 10, 5), (1, 1, 5, 7)),
               ((2, 17, 23, 3), (3, 3, 3, 16)),
               ((3, 30, 70, 16), (3, 3, 16, 40)),
               ((1, 12, 20, 600), (3, 3, 600, 7)),
               ((2, 15, 21, 8), (3, 3, 8, 32)))
# the fused kernel's pool geometries (window, stride) at every
# CONV_RAGGED shape: non-overlapping, overlapping, stride 1, mixed, and
# a stride past the window
FUSED_GEOMS = (((2, 2), (2, 2)), ((3, 3), (2, 2)), ((2, 2), (1, 1)),
               ((2, 3), (1, 2)), ((2, 2), (3, 3)))
# windows larger than a tile ((x, w), window, stride): taller than the
# conv tile's 8 rows (two row bands), wider than 32 columns (a tile of
# 64), and wider than the widest band of 2048 columns (one-row bands in
# two column segments)
FUSED_BIG = ((((3, 30, 70, 16), (3, 3, 16, 40)), (12, 5), (3, 2)),
             (((3, 30, 70, 16), (3, 3, 16, 40)), (2, 40), (2, 3)),
             (((1, 3, 2100, 2), (1, 1, 2, 4)), (3, 2090), (1, 3)))
# Conv3 with the halo staged whole at K = 270, Cin 30 a tap: seven
# channel quads (two-pair blocks) and two channels past them (one-pair
# blocks) a tap; CONV_RAGGED's Cin 600 takes the chunked path
CONV3_TAIL = (((2, 10, 20, 30), (3, 3, 30, 32)),)


# The two-tenant precision-ladder deployments (the reference's serving
# scenario at the default frontend's full widths): device budget, fuse,
# the light tenant's plan at batch 2, and the kernel its lowered plan
# must launch.
LADDER = {
    "ladder_fused": (dict(vmem_bytes=32 * 2**20,
                          vpu_ops_budget=1_000_000_000), True,
                     ["cnn_fused.fused_vpu@32", "cnn_fused.fused_mxu@8"],
                     "fused_cnn_mxu"),
    "ladder_chain": (dict(vmem_bytes=24 * 2**20,
                          vpu_ops_budget=2_000_000_000), False,
                     ["conv2d.ip1_vpu@16", "pool2d.pool_vpu@8",
                      "activation.act_vpu@16", "conv2d.ip1_vpu@32",
                      "pool2d.pool_vpu@8", "activation.act_lut@8"],
                     "activation_lut"),
}
LADDER_WAVES = 3
LADDER_MIX = {"heavy": 8, "light": 2}       # requests per wave
LADDER_OUT = (2916, 64)
MAX_QUANT_ERR = 5e-2
# Code-flip rule: at most this share of a result's elements may lie out
# of rtol=1e-4, atol=1e-5, each by at most one step of its grids.  A
# flipped int8 input code of the last block reaches up to 4 pooled
# pixels x 64 outputs, 256 of a completion's 186624 elements (0.14%),
# and the card's and the CPU's f32 sums flip about one such code per
# light completion, so the share allows a few such codes: 0.5% of the
# elements (one flipped code alone would exceed 0.1%).
FLIP_SHARE = 5e-3

# "calibration": the measurement-calibrated cost model at full width.
# Networks: the default frontend in f32 relu, and from the next seed the
# tanh frontend with the (16, 8) ladder (seed, activation, ladder), each
# at the server's bucket shapes (batches 1 to MAX_BATCH) of IMAGE.
CAL_NETWORKS = {"relu": (SEED, "relu", ()),
                "tanh_ladder": (SEED + 1, "tanh", (16, 8))}
CAL_BATCHES = tuple(range(1, MAX_BATCH + 1))
# The reference's fusion-ladder budgets (benchmarks/run.py::
# table_calibration) are sized for a (2, 32, 32, 8) input: at 224x224x3
# only "ample" and "no_mxu" are feasible, and its four VMEM- and
# VPU-starved budgets are infeasible for both arms.  This ladder keeps
# their purpose at this width: ample, logic-only, VMEM from roomy to the
# tightest both networks still plan under, and a VPU limit that moves
# the convs onto the MXU members.
CAL_BUDGETS = {"ample": {}, "no_mxu": dict(mxu_available=False),
               "vmem_24MiB": dict(vmem_bytes=24 * 2**20),
               "vmem_12MiB": dict(vmem_bytes=12 * 2**20),
               "vmem_8MiB": dict(vmem_bytes=8 * 2**20),
               "vpu_500M": dict(vpu_ops_budget=500_000_000)}
CAL_REPEAT = 5          # timed calls a sample (after one warmup call)
CAL_WINDOWS = 5         # windows of the premise
# calls an arm a window, the two arms' calls interleaved one by one: the
# host's speed drifts by up to 2x for stretches of 100 calls and more, so
# windows of one arm after the other's compared two host speeds (a run on
# an H100 decided 5 of the 11 pairs); interleaved, both arms' medians of a
# window see the same host
CAL_WINDOW_CALLS = 40
CAL_MIN_DECIDED = 6     # pairs the stopwatch must decide, of 11
CAL_MISSCALE = 4.0      # the lying table the drift monitor must flag

# "lm serve": Jamba-1.5-Large (src/repro/configs/jamba_1_5_large_398b.py,
# the repo's only architecture with Mamba layers) at full width, cut to
# one period of its stack (jamba_period) and served through
# repro_torch.launch.serve's loop: slots, requests, prompt length, tokens
# per request and cache length of the trace.
JAMBA = "jamba-1.5-large-398b"
LM_TRACE = dict(slots=4, requests=8, prompt_len=2048, max_new=16,
                max_len=2112)
# the selective scan at the served site: (B, T, Di, Ds), one prefill's
# Mamba layer
SCAN_SITE = (1, 2048, 16384, 16)
# kernel against plain version on the reference test's data
# (tests/test_kernels_mamba_scan.py:16-34): its bound; at the model's
# own operands atol is 1e-4 of each output's RMS (compare_scan)
SCAN_TOL = dict(rtol=1e-5, atol=1e-6)
SCAN_FULL_CASES = ((1, 2048, 16384, 16), (4, 512, 16384, 16))
# the backward's timed shapes: the served site and train_jamba's (one
# Mamba layer of a (1, 512) step)
SCAN_BWD_TIMED = (SCAN_SITE, (1, 512, 16384, 16))
# (B, T, Di, Ds): the reference test's CASES; a T that is no multiple
# of the kernel's chunk of 32 steps and a Di that is no multiple of its
# channels per CTA (256 / Ds), at each Ds the kernel takes
SCAN_SMALL_CASES = ((1, 8, 16, 4), (2, 16, 32, 8), (2, 12, 24, 4),
                    (2, 45, 100, 16), (1, 70, 72, 4), (3, 33, 40, 8))
# (B, T, Di, Ds): the kernel takes any d_state (PR 21): 1, 5 (zero-padded
# to 8), 32 (8 lanes a channel) at small sizes, 32 at full width, 300
# (padded to 512: four passes of 128 states)
SCAN_DS_CASES = ((1, 8, 16, 1), (2, 40, 33, 5), (1, 30, 70, 32),
                 (1, 512, 16384, 32), (1, 9, 40, 300))
# check 3: one full-width Mamba layer in f32, prefill against decode
# steps, within the reference invariant's bound
# (tests/test_model_components.py:110-126), atol at most 1e-4 of RMS
SEQ_STEPS = 64
SEQ_TOL = dict(rtol=1e-4, atol=1e-5)
# check 4: first decode step against a prefill over prompt + token, f32
HANDOFF_REL_L2 = 1e-4

# "lm families": the other LM families at full width, depth cut where
# one card cannot hold them (PERF.md section 4).  dbrx (MoE) serves
# LM_TRACE cut to DBRX_LAYERS layers in bf16; rwkv6 serves RWKV_TRACE
# whole (its time loop costs about prompt x layers x 4 launches a
# prefill, so the prompt stays at 512); llava (precomputed embeddings)
# prefills LLAVA_CASE's seeded embeddings cut to LLAVA_LAYERS layers,
# then decodes seeded (B, 1, D) embeddings; seamless (encoder-decoder)
# whole, frames and decoder prompt of SEAMLESS_CASE, then greedy steps.
DBRX = "dbrx-132b"
RWKV = "rwkv6-3b"
LLAVA = "llava-next-34b"
SEAMLESS = "seamless-m4t-large-v2"
DBRX_LAYERS = 4
LLAVA_LAYERS = 8
RWKV_TRACE = dict(slots=4, requests=8, prompt_len=512, max_new=16,
                  max_len=544)
LLAVA_CASE = dict(batch=4, prompt=2048, steps=16)
SEAMLESS_CASE = dict(batch=4, frames=1024, prompt=16, pad_to=32, steps=16)
# check 2: smoke configs in f32 on the card against the port on the CPU
FAMILY_TOL = dict(rtol=1e-4, atol=1e-5)
# check 3: full width in f32, depth cut, prefill over S + 1 against a
# prefill over S and one decode step (HANDOFF_REL_L2, same argmax)
SEQ_FAMILY_LAYERS = 2
SEQ_FAMILY_LEN = 64
# check 4: dbrx's first prefill logits, scatter against einsum dispatch
# (bf16): relative L2 within one bf16 step (2^-7), same argmax
DISPATCH_REL_L2 = 8e-3


# "train": training on one card (PERF.md section 4).  (a) the scan's
# backward against its plain version (bitwise) and, at full width,
# against the recurrence's gradient in f64: the error's RMS within
# BWD_F64_TOL["rms"] of each gradient's RMS, its largest element within
# BWD_F64_TOL["oracle"] times the f32 oracle's (autograd through the
# oracle's f32 steps, jax.grad's function): an elementwise bar of 1e-4 of
# the RMS is missed by f32 arithmetic itself at full width (PERF.md
# section 6); its bound counts per (t, di, s) one exponential and
# scan.BWD_FP32_OPS FP32 operations.  (b) the smoke
# configs, one step on the card and on the CPU (the optimizer of
# tests/test_torch_train.py), params within the CPU tests' bar; rwkv's
# grads against the f64 gradient (RWKV_ERR_FACTOR).  (c) llama3.2-1b
# whole through launch/train.py; (d) jamba_period, TRAIN_JAMBA; (e) the
# reference integration test's resume case
# (tests/test_integration.py:53-72).
BWD_F64_TOL = dict(rms=1e-4, oracle=1.5)
TRAIN_PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
RWKV_ERR_FACTOR = 1.5
TRAIN_LLAMA = "llama3.2-1b"
TRAIN_LLAMA_STEPS = 8
TRAIN_LLAMA_ARGS = ("--steps", str(TRAIN_LLAMA_STEPS), "--batch", "4",
                    "--seq", "1024")
TRAIN_LLAMA_TOKENS = 4 * 1024
TRAIN_JAMBA = dict(batch=1, seq=512, steps=3)
TRAIN_RESUME_ARGS = ("--smoke", "--steps", "24", "--batch", "4", "--seq",
                     "32", "--ckpt-every", "8")
TRAIN_FAIL_AT = 18
RESUME_TOL = 2e-2
# "train mesh": the loss bar of tests/test_torch_train.py, the (4, 1024)
# batch of train_llama, and GPipe's 4 stages of 4 llama blocks
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
# tests/test_torch_train.py's grad bar: rtol 1e-4 and an atol of 1e-4 of
# each leaf's RMS
SPLIT_GRAD_TOL = dict(rtol=1e-4, atol_rms=1e-4)
# the (4, 2) steps run the trainer's bf16 compute, where each model
# rank's row-parallel output is rounded to bf16 before the ranks' sum,
# and AdamW's first updates (about lr times the gradient's sign) carry a
# reordered sum's flipped signs into the later steps.  The first loss
# (the same params) keeps METRIC_TOL of the single device's; the later
# losses and the first grad_norm are held within MESH_BF16_LOSS_RTOL and
# MESH_BF16_NORM_RTOL, two to three times the largest readings of
# ``python3 chip_smoke.py --mesh-bf16-spread`` over MESH_SPREAD_SEEDS
# on an H100 (loss 4.80e-4, grad_norm 3.07e-4).  Each of MESH_FAULTS
# misses them there (kv_swap, the nearest: losses 1.29e-2 off at
# least); the phase runs kv_swap as its control.  The split itself is
# held bitwise by mesh_bitwise_check and in f32 by mesh_split_checks.
MESH_BF16_LOSS_RTOL = 1e-3
MESH_BF16_NORM_RTOL = 1e-3
MESH_SPREAD_SEEDS = (0, 1, 2, 3, 4, 5)
MESH_FAULTS = ("drop", "kv_swap")
MESH_TRAIN = dict(batch=4, seq=1024, steps=3)
# (b) the expert-hidden split: grok smoke's 4 experts on a model degree
# of 8 (d_ff 128: 16 hidden columns a rank), at (batch, seq)
MESH_HIDDEN = ("grok-1-314b", (1, 8), 8, 32)
# (b) RWKV's heads on a model degree they do not divide: rwkv6-3b smoke's
# 4 heads of 16 on (1, 8) (a stored block is half a head; ranks 1, 3, 5,
# 7 own one head each), at (batch, seq)
MESH_RWKV = ("rwkv6-3b", (1, 8), 8, 32)
GPIPE = dict(stages=4, micro=8, seq=1024)

# "dryrun" (PERF.md sections 2-3): (a) the production dry-run's cells on
# meta at full size, each a `python -m repro_torch.launch.dryrun` process
# (all at once, beside the "examples" phase); the static bytes a device
# are the values tests/test_torch_dryrun.py holds to the reference's.
# (b) the same counters around the same step on meta and on logical
# devices of the card: llama3.2-1b at full width cut to GROUND_LAYERS
# layers, train (8, 512), without and with FSDP, and jamba's smoke
# config at (8, 64), all on a (2, 2) mesh, and smoke decode steps on
# (2, 4); FLOPs, bytes and collective bytes equal rank by rank.  (c)
# launch/report.py renders (a)-(b)'s records.
DRYRUN_CELLS = (("olmo-1b", "train_4k", "single", True),
                ("jamba-1.5-large-398b", "decode_32k", "single", False),
                ("grok-1-314b", "train_4k", "multi", False),
                ("rwkv6-3b", "decode_32k", "single", False),
                ("seamless-m4t-large-v2", "decode_32k", "single", False),
                ("jamba-1.5-large-398b", "long_500k", "single", False),
                ("llava-next-34b", "decode_32k", "single", False))
DRYRUN_STATIC = {("olmo-1b", "train_4k"): 882573316.0,
                 ("jamba-1.5-large-398b", "decode_32k"): 3775279104.0,
                 ("grok-1-314b", "train_4k"): 3855716356.0,
                 ("rwkv6-3b", "decode_32k"): 1768509440.0,
                 ("seamless-m4t-large-v2", "decode_32k"): 5597888512.0,
                 ("jamba-1.5-large-398b", "long_500k"): 3215185920.0,
                 ("llava-next-34b", "decode_32k"): 5122676736.0}
DRYRUN_TIMEOUT_S = 600
GROUND_LAYERS = 2
# (arch, smoke, batch, seq, fsdp): llama's FSDP step gathers each layer
# group's blocks over "data" as the group runs (forward and recompute)
# and reduce-scatters its gradient onto the blocks
GROUND_CASES = (("llama3.2-1b", False, 8, 512, False),
                ("jamba-1.5-large-398b", True, 8, 64, False),
                ("llama3.2-1b", False, 8, 512, True))
# (b) serving decode steps on (2, 4): (arch (smoke), (data, model),
# batch, cache length, position, the cache that is checked, its layout,
# config changes): jamba's attention cache split by sequence over
# "model" (2 kv heads), seamless's frozen cross-attention cache by kv
# head, rwkv's state whole (replicated over "model", its heads run
# split); jamba at batch 1, its cache split by sequence over ("data",
# "model"); a llava whose 6 query heads and 2 kv heads do not divide 4,
# its attention whole on the first model rank and its cache split by
# sequence over "model"
GROUND_DECODES = (("jamba-1.5-large-398b", (2, 4), 16, 64, 37, "sub0/k",
                   "sequence", {}),
                  ("seamless-m4t-large-v2", (2, 4), 16, 64, 37, "xk",
                   "kv head", {}),
                  ("rwkv6-3b", (2, 4), 16, 64, 37, "sub0/state", "whole",
                   {}),
                  ("jamba-1.5-large-398b", (2, 4), 1, 64, 37, "sub0/k",
                   "sequence over data", {}),
                  ("llava-next-34b", (2, 4), 16, 64, 37, "sub0/k",
                   "sequence", dict(n_heads=6, n_kv_heads=2)))
EXAMPLES_AT_ONCE = 2
EXAMPLE_TIMEOUT_S = 300


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def clock_line() -> str:
    """The card's SM clock, its maximum, power draw and temperature now,
    as nvidia-smi reads them (a time taken under a lower clock reads
    slower)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def peaks_for(name: str) -> dict:
    key = "H100 PCIe" if "PCIe" in name else "H100 SXM"
    check("H100" in name, f"no peak table for card {name!r}")
    return PEAKS[key]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def compare(name, got, want, rtol, atol, errs, exact=False):
    import torch
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {tuple(got.shape)}/{got.dtype} vs "
          f"{tuple(want.shape)}/{want.dtype}")
    diff = (got.double() - want.double()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if exact:
        check(torch.equal(got, want), f"{name}: not bit-exact "
                                      f"(max abs err {err})")
    else:
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{name}: {m}")
    errs[name] = max(errs.get(name, 0.0), err)
    log(f"{name}: ok (max abs err {err:.3e}"
        f"{', bit-exact' if exact else ''})")


def kernel_checks(shapes, gen):
    import torch
    from repro_torch.kernels.activation.ref import KINDS
    from repro_torch.kernels.activation.vpu_exact import (
        activation_exact, activation_exact_plain)
    from repro_torch.kernels.conv2d.ip1_vpu import conv2d_ip1, conv2d_ip1_plain
    from repro_torch.kernels.conv2d.ip2_mxu import conv2d_ip2, conv2d_ip2_plain
    from repro_torch.kernels.fused.cnn_block import (fused_cnn_mxu,
                                                     fused_cnn_plain,
                                                     fused_cnn_vpu)
    from repro_torch.kernels.pool2d.vpu_window import (pool2d_window,
                                                       pool2d_window_plain)

    dev = torch.device("cuda")
    errs = {}
    conv = {"vpu": (conv2d_ip1, conv2d_ip1_plain, "conv2d_ip1"),
            "mxu": (conv2d_ip2, conv2d_ip2_plain, "conv2d_ip2")}
    fused = {"vpu": (fused_cnn_vpu, "fused_cnn_vpu"),
             "mxu": (fused_cnn_mxu, "fused_cnn_mxu")}

    def randn(shape):
        return torch.randn(shape, generator=gen).to(dev)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int8).to(dev)

    for block, (xs, ws) in shapes.items():
        x, w = randn(xs), randn(ws) * (ws[0] * ws[1] * ws[2]) ** -0.5
        xi, wi = randint(-128, 127, xs), randint(-128, 127, ws)
        for style, (kern, plain, name) in conv.items():
            compare(name, kern(x, w), plain(x, w), 1e-4, 1e-5, errs)
            compare(name, kern(xi, wi), plain(xi, wi), 0, 0, errs,
                    exact=True)
            # tiling hints shape the grid, never the result
            check(torch.equal(kern(x, w, block_cout=5), kern(x, w)),
                  f"{name}: result depends on block_cout")
        y = conv2d_ip1(x, w)
        yi = conv2d_ip1(xi, wi)
        for mode in ("max", "avg"):
            compare("pool2d_window", pool2d_window(y, mode=mode),
                    pool2d_window_plain(y, mode=mode), 1e-6, 1e-6, errs)
            for t in (xi, yi):          # int8 and int32 (negative sums)
                compare("pool2d_window", pool2d_window(t, mode=mode),
                        pool2d_window_plain(t, mode=mode), 0, 0, errs,
                        exact=True)
        check(torch.equal(pool2d_window(y, block_c=3), pool2d_window(y)),
              "pool2d_window: result depends on block_c")
        pooled = pool2d_window(y)
        for kind in KINDS:
            compare("activation_exact", activation_exact(pooled, kind=kind),
                    activation_exact_plain(pooled, kind=kind), 1e-6, 1e-6,
                    errs)
        compare("activation_exact", activation_exact(yi, kind="relu"),
                activation_exact_plain(yi, kind="relu"), 0, 0, errs,
                exact=True)
        check(torch.equal(activation_exact(pooled, block_rows=7),
                          activation_exact(pooled)),
              "activation_exact: result depends on block_rows")
        # NaN propagates through max-pool and relu, as in the reference
        ynan = y.clone()
        ynan[0, 0, 0, 0] = float("nan")
        check(bool(torch.isnan(activation_exact(
            pool2d_window(ynan))[0, 0, 0, 0])), "NaN dropped by max/relu")

        scale = torch.rand(ws[-1], generator=gen).to(dev) * 1e-3
        for style, (kern, name) in fused.items():
            ckern = conv[style][0]
            for mode, kind in (("max", "relu"), ("avg", "tanh"),
                               ("max", "gelu")):
                got = kern(x, w, pool_mode=mode, act_kind=kind)
                compare(name, got, fused_cnn_plain(
                    style, x, w, pool_mode=mode, act_kind=kind), 1e-4, 1e-5,
                    errs)
                chain = activation_exact(pool2d_window(ckern(x, w),
                                                       mode=mode), kind=kind)
                check(torch.equal(got, chain),
                      f"{name} ({mode}, {kind}): not bitwise equal to its "
                      f"three-launch chain")
            for mode in ("max", "avg"):
                compare(name, kern(xi, wi, pool_mode=mode),
                        fused_cnn_plain(style, xi, wi, pool_mode=mode),
                        0, 0, errs, exact=True)
                compare(name, kern(xi, wi, scale, pool_mode=mode),
                        fused_cnn_plain(style, xi, wi, scale,
                                        pool_mode=mode), 0, 0, errs,
                        exact=True)
            check(torch.equal(kern(x, w, block_cout=3), kern(x, w)),
                  f"{name}: result depends on block_cout")
        log(f"{block}: fused == chain bitwise for both styles")
    torch.cuda.synchronize()
    return errs


def conv_ragged_checks(gen, errs):
    """conv2d_ip1 and conv2d_ip2 (the tiled kernels) at CONV_RAGGED
    against their plain versions: f32 within tolerance, int8 bit-exact,
    both independent of block_cout; f32 fused_cnn_vpu / fused_cnn_mxu
    bitwise equal to their three-launch chains (conv2d_ip1 / conv2d_ip2,
    pool2d_window, activation_exact) at the same shapes."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.kernels.activation.vpu_exact import activation_exact
    from repro_torch.kernels.conv2d.ip1_vpu import (conv2d_ip1,
                                                    conv2d_ip1_plain,
                                                    tile_plan)
    from repro_torch.kernels.conv2d.ip2_mxu import conv2d_ip2, conv2d_ip2_plain
    from repro_torch.kernels.fused.cnn_block import (fused_cnn_mxu,
                                                     fused_cnn_vpu)
    from repro_torch.kernels.pool2d.vpu_window import pool2d_window
    dev = torch.device("cuda")
    plans, plans2 = [], []
    for xs, ws in CONV_RAGGED:
        x = torch.randn(xs, generator=gen).to(dev)
        w = (torch.randn(ws, generator=gen)
             * (ws[0] * ws[1] * ws[2]) ** -0.5).to(dev)
        xi = torch.randint(-128, 127, xs, generator=gen,
                           dtype=torch.int8).to(dev)
        wi = torch.randint(-128, 127, ws, generator=gen,
                           dtype=torch.int8).to(dev)
        y = conv2d_ip1(x, w)
        compare("conv2d_ip1", y, conv2d_ip1_plain(x, w), 1e-4, 1e-5, errs)
        compare("conv2d_ip1", conv2d_ip1(xi, wi), conv2d_ip1_plain(xi, wi),
                0, 0, errs, exact=True)
        for bc in (1, 5, 16):
            check(torch.equal(conv2d_ip1(x, w, block_cout=bc), y)
                  and torch.equal(conv2d_ip1(xi, wi, block_cout=bc),
                                  conv2d_ip1(xi, wi)),
                  f"conv2d_ip1 at {xs} x {ws}: result depends on "
                  f"block_cout")
        check(torch.equal(fused_cnn_vpu(x, w), activation_exact(
            pool2d_window(y))), f"fused_cnn_vpu at {xs} x {ws}: not "
                                f"bitwise equal to its three-launch chain")
        n, h, w_, cin = xs
        plans.append(tuple(
            tile_plan(h, w_, cin, *ws[:2], ws[3], itemsize=size)
            for size in (4, 1)))
        cuda.reset_launches()
        y2 = conv2d_ip2(x, w)
        yi2 = conv2d_ip2(xi, wi)
        check(cuda.launch_counts() == {"conv2d_ip2": 2},
              f"conv2d_ip2 at {xs} x {ws}: launches "
              f"{cuda.launch_counts()}, expected 2")
        compare("conv2d_ip2", y2, conv2d_ip2_plain(x, w), 1e-4, 1e-5, errs)
        compare("conv2d_ip2", yi2, conv2d_ip2_plain(xi, wi), 0, 0, errs,
                exact=True)
        for bc in (1, 5, 16):
            check(torch.equal(conv2d_ip2(x, w, block_cout=bc), y2)
                  and torch.equal(conv2d_ip2(xi, wi, block_cout=bc), yi2),
                  f"conv2d_ip2 at {xs} x {ws}: result depends on "
                  f"block_cout")
        check(torch.equal(fused_cnn_mxu(x, w), activation_exact(
            pool2d_window(y2))), f"fused_cnn_mxu at {xs} x {ws}: not "
                                 f"bitwise equal to its three-launch chain")
        plans2.append(tuple(
            tile_plan(h, w_, cin, *ws[:2], ws[3], itemsize=size,
                      style="mxu") for size in (4, 1)))
    log(f"conv2d_ip1 at {len(CONV_RAGGED)} ragged shapes: f32 within "
        f"rtol=1e-4, atol=1e-5, int8 bit-exact, independent of "
        f"block_cout; f32 fused_cnn_vpu == chain bitwise; tile plans "
        f"(f32, int8) {plans}")
    log(f"conv2d_ip2 ({KERNEL['conv2d_ip2']}, one launch a call) at "
        f"{len(CONV_RAGGED)} ragged shapes: f32 within rtol=1e-4, "
        f"atol=1e-5, int8 bit-exact, independent of block_cout; f32 "
        f"fused_cnn_mxu == chain bitwise; tile plans (f32, int8) {plans2}")
    torch.cuda.synchronize()


def conv_dtype_checks(gen, errs):
    """The tiled conv2d_ip1 and conv2d_ip2 at CONV_RAGGED on bf16 and
    int16 (integers over their full range, wrapping in int32): one launch
    a call, block_cout 1, 5, 16 and 128 giving the same bits, int16 exact
    and bf16 within rtol=1e-4, atol=1e-5 of the plain versions; the fused
    blocks of both styles bitwise equal to their three-launch chains on
    both dtypes."""
    import torch
    from repro_torch.kernels.activation.vpu_exact import activation_exact
    from repro_torch.kernels.conv2d.ip1_vpu import conv2d_ip1, conv2d_ip1_plain
    from repro_torch.kernels.conv2d.ip2_mxu import conv2d_ip2, conv2d_ip2_plain
    from repro_torch.kernels.fused.cnn_block import (fused_cnn_mxu,
                                                     fused_cnn_vpu)
    from repro_torch.kernels.pool2d.vpu_window import pool2d_window
    members = (("conv2d_ip1", conv2d_ip1, conv2d_ip1_plain, fused_cnn_vpu),
               ("conv2d_ip2", conv2d_ip2, conv2d_ip2_plain, fused_cnn_mxu))
    for xs, ws in CONV_RAGGED:
        scale = (ws[0] * ws[1] * ws[2]) ** -0.5
        for dtype in (torch.bfloat16, torch.int16):
            x, w = operand(gen, xs, dtype), operand(gen, ws, dtype, scale)
            exact = not dtype.is_floating_point
            for name, kern, plain, fused in members:
                what = f"{name} {dtype} at {xs} x {ws}"
                y = launched_once(lambda: kern(x, w), name, what)
                compare(name, y, plain(x, w), 1e-4, 1e-5, errs, exact=exact)
                for bc in (1, 5, 16):
                    check(torch.equal(kern(x, w, block_cout=bc), y),
                          f"{what}: result depends on block_cout ({bc})")
                for mode, kind in (("max", "relu"), ("avg", "tanh")):
                    check(torch.equal(
                        fused(x, w, pool_mode=mode, act_kind=kind),
                        activation_exact(pool2d_window(y, mode=mode),
                                         kind=kind)),
                          f"{what}: fused ({mode}, {kind}) not bitwise "
                          f"equal to its three-launch chain")
    log(f"conv2d_ip1 / conv2d_ip2 at {len(CONV_RAGGED)} ragged shapes on "
        f"bf16 and int16: one launch a call, int16 exact, bf16 within "
        f"rtol=1e-4, atol=1e-5, block_cout 1/5/16/128 bitwise; "
        f"fused_cnn_vpu / fused_cnn_mxu == chain bitwise (max relu, avg "
        f"tanh)")
    torch.cuda.synchronize()


def fused_geometry_checks(gen, errs):
    """fused_cnn_vpu / fused_cnn_mxu (fused_cnn_tiled_kernel) at every
    CONV_RAGGED shape under FUSED_GEOMS and at FUSED_BIG, max (relu) and
    avg (tanh), on f32, bf16, int16, native int8 and the int8 rung
    (scale=), integers over their full range: one launch a call; but on
    the rung (no standalone chain rescales), bitwise equal to the
    three-launch chain (conv2d_ip1 / conv2d_ip2, pool2d_window,
    activation_exact); against fused_cnn_plain, integers and the rung
    bit-exact under relu and within 1e-6 under tanh (CUDA's tanhf
    against torch's), f32 and bf16 within rtol=1e-4, atol=1e-5;
    block_cout 1, 5, 16 and 128 bitwise.  FUSED_BIG's plans must walk
    two row bands, a 64-column tile and two column segments."""
    import torch
    from repro_torch.kernels.activation.vpu_exact import activation_exact
    from repro_torch.kernels.conv2d.inner import fused_plan
    from repro_torch.kernels.conv2d.ip1_vpu import conv2d_ip1
    from repro_torch.kernels.conv2d.ip2_mxu import conv2d_ip2
    from repro_torch.kernels.fused.cnn_block import (fused_cnn_mxu,
                                                     fused_cnn_plain,
                                                     fused_cnn_vpu)
    from repro_torch.kernels.pool2d.vpu_window import pool2d_window
    styles = {"vpu": (fused_cnn_vpu, conv2d_ip1, "fused_cnn_vpu"),
              "mxu": (fused_cnn_mxu, conv2d_ip2, "fused_cnn_mxu")}
    cases = [(xs, ws, win, st) for xs, ws in CONV_RAGGED
             for win, st in FUSED_GEOMS]
    cases += [(xs, ws, win, st) for (xs, ws), win, st in FUSED_BIG]
    big = []
    for xs, ws, win, st in cases:
        plan = fused_plan(*xs[1:], *ws[:2], ws[3], *win, *st, itemsize=4)
        if ((xs, ws), win, st) in FUSED_BIG:
            big.append(plan)
        for dname in ("float32", "bfloat16", "int16", "int8", "int8 rung"):
            dtype = getattr(torch, dname.split()[0])
            x = operand(gen, xs, dtype)
            w = operand(gen, ws, dtype, (ws[0] * ws[1] * ws[2]) ** -0.5)
            sc = None
            if dname == "int8 rung":
                sc = (torch.rand(ws[-1], generator=gen) * 1e-3).cuda()
            # integer convs and the rung's rescale are exact; so is
            # relu, while tanh is CUDA's tanhf against torch's own
            ints = sc is not None or not dtype.is_floating_point
            tol = (1e-6, 1e-6) if ints else (1e-4, 1e-5)
            for style, (kern, conv, name) in styles.items():
                for mode, kind in (("max", "relu"), ("avg", "tanh")):
                    kw = dict(pool_window=win, pool_stride=st,
                              pool_mode=mode, act_kind=kind)
                    what = f"{name} {dname} at {xs} x {ws}, {win}/{st} {mode}"
                    got = launched_once(lambda: kern(x, w, sc, **kw), name,
                                        what)
                    compare(name, got, fused_cnn_plain(style, x, w, sc, **kw),
                            *tol, errs, exact=ints and kind == "relu")
                    if sc is None:
                        chain = activation_exact(pool2d_window(
                            conv(x, w), window=win, stride=st, mode=mode),
                            kind=kind)
                        check(torch.equal(got, chain), f"{what}: not bitwise "
                              f"equal to its three-launch chain")
                    for bc in (1, 5, 16):
                        check(torch.equal(kern(x, w, sc, block_cout=bc, **kw),
                                          got),
                              f"{what}: result depends on block_cout ({bc})")
    check(big[0].row_bands > 1 and big[1].tile.tw > 32
          and big[2].col_segs > 1, f"FUSED_BIG plans {big}")
    log(f"fused_cnn_vpu / fused_cnn_mxu ({KERNEL['fused_cnn_vpu']}, one "
        f"launch a call) at {len(CONV_RAGGED)} ragged shapes x "
        f"{FUSED_GEOMS} and FUSED_BIG, max relu and avg tanh, f32, bf16, "
        f"int16, int8 and the int8 rung: == chain bitwise (not the rung), "
        f"integers and the rung bit-exact (relu; tanh within 1e-6), floats "
        f"within rtol=1e-4, atol=1e-5 of the plain version, block_cout "
        f"1/5/16/128 bitwise; "
        f"FUSED_BIG plans (f32) {big}")
    torch.cuda.synchronize()


def conv3_checks(gen, errs):
    """conv2d_ip3 (conv2d_ip3_tiled_kernel) at CONV_RAGGED and
    CONV3_TAIL on full-range int8 (-128 in every operand), block_cout
    1, 5, 16 and 128: one launch a call, results independent of
    block_cout, both streams bit-exact against conv2d_ip3_plain and
    against two conv2d_ip1 launches."""
    import torch
    from repro_torch.kernels.conv2d.inner import tile_plan
    from repro_torch.kernels.conv2d.ip1_vpu import conv2d_ip1
    from repro_torch.kernels.conv2d.ip3_packed import (conv2d_ip3,
                                                       conv2d_ip3_plain)
    plans = []
    for xs, ws in CONV_RAGGED + CONV3_TAIL:
        xa, xb, w = (operand(gen, s_, torch.int8) for s_ in (xs, xs, ws))
        for t in (xa, xb, w):
            t.view(-1)[0] = -128
        what = f"conv2d_ip3 at {xs} x {ws}"
        ys = None
        for bc in (128, 16, 5, 1):
            got = launched_once(lambda: conv2d_ip3(xa, xb, w, block_cout=bc),
                                "conv2d_ip3", f"{what}, block_cout {bc}")
            if ys is None:
                ys = got
            check(all(torch.equal(u, v) for u, v in zip(got, ys)),
                  f"{what}: result depends on block_cout ({bc})")
        for got, want in zip(ys, conv2d_ip3_plain(xa, xb, w)):
            compare("conv2d_ip3", got, want, 0, 0, errs, exact=True)
        check(torch.equal(ys[0], conv2d_ip1(xa, w))
              and torch.equal(ys[1], conv2d_ip1(xb, w)),
              f"{what}: not bitwise equal to two conv2d_ip1 launches")
        plans.append((tile_plan(*xs[1:], *ws[:2], ws[3], itemsize=1,
                                style="packed"),
                      ws[0] * ws[1] * ws[2]))
    log(f"conv2d_ip3 ({KERNEL['conv2d_ip3']}, one launch a call) at "
        f"{len(CONV_RAGGED)} ragged shapes and CONV3_TAIL, full-range int8, "
        f"block_cout 1/5/16/128: bit-exact against the plain version and "
        f"two conv2d_ip1 launches; (tile plan, K) {plans}")
    torch.cuda.synchronize()


# activation_exact's checks: numels (a lone element, a ragged short
# tensor, one past a vector multiple, the frontend's pooled block 1) and
# the storage offsets of the input in bytes (16-byte aligned, 4 bytes
# past a boundary)
ACT_SHAPES = ((1,), (7,), (4097,), (4, 111, 111, 16))
ACT_OFFSETS = (0, 4)


def activation_checks(gen, errs):
    """activation_exact (the vector kernel) on every dtype it takes at
    ACT_SHAPES, with the input's storage at ACT_OFFSETS bytes past a
    16-byte boundary: one launch a call, every kind; relu and relu6
    bitwise, integer inputs bitwise for those and within 1e-6 for the
    rest, f32 within 1e-6 and bf16 within one bf16 rounding (rtol
    2^-8, atol 1e-6) of the plain version; and f32 bitwise equal to the
    fused kernels' activation (fused_cnn_vpu / fused_cnn_mxu with an
    identity 1x1 conv and a 1x1 pool feed activate the input itself)."""
    import torch
    from repro_torch.kernels.activation.ref import KINDS
    from repro_torch.kernels.activation.vpu_exact import (
        CUDA_DTYPES, activation_exact, activation_exact_plain)
    from repro_torch.kernels.fused.cnn_block import (fused_cnn_mxu,
                                                     fused_cnn_vpu)
    dev = torch.device("cuda")
    for dtype in CUDA_DTYPES:
        size = torch.empty((), dtype=dtype).element_size()
        for shape in ACT_SHAPES:
            n = math.prod(shape)
            base = torch.randn(n + 16, generator=gen) * 3
            if not dtype.is_floating_point:
                base = (base * 20).round().clamp(-128, 127)
            base = base.to(dtype).to(dev)
            for off in ACT_OFFSETS:
                x = base[off // size:off // size + n].view(shape)
                check(x.data_ptr() % 16 == off, "activation input offset")
                for kind in KINDS:
                    got = launched_once(
                        lambda: activation_exact(x, kind=kind),
                        "activation_exact",
                        f"activation_exact {dtype} {shape} +{off} B {kind}")
                    exact = kind in ("relu", "relu6")
                    tol = ((2 ** -8, 1e-6) if dtype == torch.bfloat16
                           else (1e-6, 1e-6))
                    compare("activation_exact", got,
                            activation_exact_plain(x, kind=kind), *tol,
                            errs, exact=exact)
                    if dtype == torch.float32 and len(shape) == 4:
                        c = shape[-1]
                        eye = torch.eye(c, device=dev).view(1, 1, c, c)
                        for fused in (fused_cnn_vpu, fused_cnn_mxu):
                            check(torch.equal(fused(
                                x, eye, pool_window=(1, 1), act_kind=kind),
                                got), f"activation_exact {kind} at +{off} "
                                      f"B: not bitwise equal to the fused "
                                      f"kernels' activation")
    log(f"activation_exact (activation_kernel, 16-byte vectors, one launch "
        f"a call) on {[str(d) for d in CUDA_DTYPES]} at {ACT_SHAPES}, input "
        f"at {ACT_OFFSETS} bytes past a 16-byte boundary, every kind: equal "
        f"to the plain version (relu/relu6 bitwise), f32 bitwise equal to "
        f"the fused kernels' activation")
    torch.cuda.synchronize()


def bf16_elementwise_checks(gen, errs):
    """The pool, LUT and activation kernels on bf16 at the served pooled
    shapes: max pools bitwise (bf16 out), avg pools within 1e-6 (f32
    out), the LUT bitwise (bf16 out: the f32 entry rounded once),
    activation_exact within one bf16 rounding (relu bitwise)."""
    import torch
    from repro_torch.kernels.activation.lut_poly import (
        RANGES, activation_lut, activation_lut_plain)
    from repro_torch.kernels.activation.vpu_exact import (
        activation_exact, activation_exact_plain)
    from repro_torch.kernels.pool2d.mxu_im2col import (pool2d_im2col,
                                                       pool2d_im2col_plain)
    from repro_torch.kernels.pool2d.vpu_window import (pool2d_window,
                                                       pool2d_window_plain)
    dev = torch.device("cuda")
    for shape in ((4, 222, 222, 16), (4, 54, 54, 32)):
        x = (torch.randn(shape, generator=gen) * 3).to(torch.bfloat16).to(dev)
        for name, kern, plain in (
                ("pool2d_window", pool2d_window, pool2d_window_plain),
                ("pool2d_im2col", pool2d_im2col, pool2d_im2col_plain)):
            for mode in ("max", "avg"):
                got = launched_once(lambda: kern(x, mode=mode), name,
                                    f"{name} bf16 {mode} {shape}")
                compare(name, got, plain(x, mode=mode), 1e-6, 1e-6, errs,
                        exact=mode == "max")
        for kind in sorted(RANGES):
            compare("activation_lut", launched_once(
                lambda: activation_lut(x, kind=kind), "activation_lut",
                f"activation_lut bf16 {kind}"),
                activation_lut_plain(x, kind=kind), 0, 0, errs, exact=True)
        compare("activation_exact", activation_exact(x),
                activation_exact_plain(x), 0, 0, errs, exact=True)
        compare("activation_exact", activation_exact(x, kind="tanh"),
                activation_exact_plain(x, kind="tanh"), 2 ** -8, 1e-6, errs)
    log("bf16: pool2d_window and pool2d_im2col (max bitwise in bf16, avg "
        "within 1e-6 in f32), activation_lut bitwise in bf16, "
        "activation_exact relu bitwise and tanh within one bf16 rounding")
    torch.cuda.synchronize()


# pool2d_window's checks (the geometries of tests/test_torch_kernels_cnn.py
# ::POOL_PLANS, and larger ones): x shape, window, stride, storage offset
# of x in elements.  C of 16, 32, 48 and 64 take 16-byte vectors in every
# dtype, 3, 7, 17 and 33 the scalar path; 2x2 / 2, 3x3 / 1 and 2, 1x3 /
# (1, 2), 3x3 / (1, 2), a window as large as the input, a 56x56 window
# (784 chunks of taps), N > 1; an offset of one element (an int8 input
# one byte past a 16-byte boundary) or three takes the scalar path too.
POOL_CHECKS = (((2, 9, 10, 16), (2, 2), None, 0),
               ((1, 9, 11, 3), (3, 3), (1, 1), 0),
               ((2, 11, 9, 7), (3, 3), (2, 2), 0),
               ((1, 8, 13, 17), (1, 3), (1, 2), 0),
               ((2, 7, 9, 33), (2, 2), None, 0),
               ((1, 6, 7, 16), (6, 7), None, 0),
               ((2, 10, 10, 32), (3, 3), (1, 1), 0),
               ((2, 9, 10, 16), (2, 2), None, 1),
               ((2, 13, 21, 48), (3, 3), (1, 2), 1),
               ((3, 57, 91, 48), (3, 3), (2, 2), 0),
               ((2, 64, 64, 64), (2, 2), None, 3),
               ((1, 60, 61, 4), (56, 56), (1, 1), 0))


def pool_geometry_checks(gen, errs):
    """Both pool members on pool_plan's cut (pool2d_window runs
    pool2d_kernel, pool2d_im2col pool2d_im2col_kernel: one body,
    pool_window) at POOL_CHECKS in every dtype they take, max and avg,
    one launch a call: max and integers bitwise equal to the plain
    version, float avg within 1e-6 of it on the card (whose scalar
    division may differ by an ulp) and bitwise equal to it on the CPU;
    pool2d_im2col bitwise equal to pool2d_window; the plan takes 16-byte
    vectors exactly where C * itemsize is a multiple of 16 and the input
    is aligned; a NaN propagates through max on both paths, with and
    without overlapping windows; the C entries refuse what they cannot
    run (pool_refusal_checks)."""
    import torch
    from repro_torch.kernels.pool2d.mxu_im2col import (pool2d_im2col,
                                                       pool2d_im2col_plain)
    from repro_torch.kernels.pool2d.ref import norm_window_stride
    from repro_torch.kernels.pool2d.vpu_window import (
        CUDA_DTYPES, pool2d_window, pool2d_window_plain, pool_plan)
    members = (("pool2d_window", pool2d_window, pool2d_window_plain),
               ("pool2d_im2col", pool2d_im2col, pool2d_im2col_plain))
    dev = torch.device("cuda")
    paths = set()
    for dtype in CUDA_DTYPES:
        size = torch.empty((), dtype=dtype).element_size()
        for xs, window, stride, off in POOL_CHECKS:
            numel = math.prod(xs)
            base = torch.randn(numel + off, generator=gen) * 3
            if not dtype.is_floating_point:
                base = (base * 40).round().clamp(-128, 127)
            base = base.to(dtype).to(dev)
            x = base[off:].view(xs)
            (kh, kw), (sh, sw) = norm_window_stride(window, stride)
            n, h, w, c = xs
            plan = pool_plan(n, h, w, c, kh, kw, sh, sw, itemsize=size,
                             x_addr=x.data_ptr())
            vec = (c * size) % 16 == 0 and x.data_ptr() % 16 == 0
            check(plan.ve == (16 // size if vec else 1),
                  f"pool_plan {dtype} {xs} {window} +{off}: {plan}")
            paths.add((str(dtype).split(".")[1], c, off, plan.ve))
            for mode in ("max", "avg"):
                kw_ = dict(window=window, stride=stride, mode=mode)
                exact = mode == "max" or not dtype.is_floating_point
                got = {}
                for name, kern, plain in members:
                    what = f"{name} {dtype} {xs} {window} {stride} +{off} {mode}"
                    got[name] = launched_once(lambda: kern(x, **kw_), name,
                                              what)
                    compare(name, got[name], plain(x, **kw_), 1e-6, 1e-6,
                            errs, exact=exact)
                    if not exact:
                        check(torch.equal(got[name].cpu(),
                                          plain(x.cpu(), **kw_)),
                              f"{what}: not bitwise the plain version on "
                              f"the CPU")
                check(torch.equal(got["pool2d_im2col"], got["pool2d_window"]),
                      f"pool2d_im2col {dtype} {xs} {window} {stride} +{off} "
                      f"{mode}: not bitwise pool2d_window")
    for name, kern, _ in members:
        for c in (16, 17):                  # the vector and the scalar path
            x = torch.randn((1, 6, 6, c), generator=gen).to(dev)
            x[0, 2, 3, 5] = float("nan")
            got = kern(x)
            check(bool(torch.isnan(got[0, 1, 1, 5]))
                  and int(torch.isnan(got).sum()) == 1,
                  f"{name} C={c}: max did not propagate one NaN")
            got = kern(x, window=(2, 2), stride=(1, 1))
            check(bool(torch.isnan(got[0, 1:3, 2:4, 5]).all())
                  and int(torch.isnan(got).sum()) == 4,
                  f"{name} C={c} 2x2 / 1: max did not propagate a NaN")
    log(f"pool2d_window (pool2d_kernel) and pool2d_im2col "
        f"(pool2d_im2col_kernel) at {len(POOL_CHECKS)} geometries x "
        f"{[str(d) for d in CUDA_DTYPES]} x max/avg, one launch a call: max "
        f"and integers bitwise, float avg within 1e-6 on the card and "
        f"bitwise on the CPU; im2col == window bitwise; paths (dtype, C, "
        f"offset, ve): {sorted(paths)}")
    pool_refusal_checks()
    torch.cuda.synchronize()


def pool_refusal_checks():
    """Both pool C entries (cnn_pool2d, cnn_pool2d_im2col) refuse, with
    cudaErrorInvalidValue and before any launch, an unknown dtype, an
    unknown mode, a window larger than the input, plans that do not cover
    the output exactly (one lane short, one CTA short or over, a vector
    width on an unaligned input) and a geometry past 32-bit index math
    (H * W * C = 2^32); the same arguments with the plan of pool_plan
    are taken."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.kernels.pool2d.vpu_window import pool_plan
    lib = cuda.lib()
    invalid = 1                                  # cudaErrorInvalidValue
    x = torch.zeros(1024, device="cuda")
    y = torch.zeros(1024, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    f32, i16, avg = 0, 3, 1

    def args(geom, plan, dtype=f32, mode=avg, xp=x.data_ptr()):
        return (dtype, mode, xp, y.data_ptr(), *geom, plan.ve, plan.outs,
                plan.lanes, plan.ctas, stream)

    small = (1, 4, 9, 4, 2, 2, 1, 1)             # N, H, W, C, KH, KW, SH, SW
    ok = pool_plan(*small, itemsize=4)
    big = (1, 65536, 65536, 1, 2, 2, 2, 2)
    cases = {
        "int16 dtype": args(small, ok, dtype=i16),
        "mode 2": args(small, ok, mode=2),
        "window larger than the input": args((1, 4, 9, 4, 5, 2, 1, 1), ok),
        "one lane short": args(small, ok._replace(lanes=ok.lanes - 1)),
        "one CTA over": args(small, ok._replace(ctas=ok.ctas + 1)),
        "one CTA short": args(small, ok._replace(ctas=ok.ctas - 1)),
        "vectors on an unaligned input": args(small, ok,
                                              xp=x.data_ptr() + 4),
        "H * W * C = 2^32": args(big, pool_plan(*big, itemsize=4)),
    }
    for entry in ("cnn_pool2d", "cnn_pool2d_im2col"):
        fn = getattr(lib, entry)
        for what, a in cases.items():
            err = fn(*a)
            check(err == invalid, f"{entry} took {what} (returned {err})")
        err = fn(*args(small, ok))
        check(err == 0, f"{entry} refused pool_plan's plan (returned {err})")
    torch.cuda.synchronize()
    log(f"cnn_pool2d and cnn_pool2d_im2col refuse: {', '.join(cases)}")


def lut_walk_checks(gen, errs):
    """activation_lut on act_walk: the launcher's split (the query
    cnn_activation_plan) equal to vpu_exact.walk_plan at byte offsets
    0-15 (misaligned ones refused by both), numels 0, 1, 15, a tile +-1
    and more tiles than the grid; then activation_lut bitwise equal to
    its plain version on every dtype at those offsets and numels, every
    kind, one launch a call (numel 0: none), NaN on entry 0 and +-inf
    on the end entries."""
    import ctypes
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.kernels.activation.lut_poly import (
        CUDA_DTYPES, RANGES, activation_lut, activation_lut_plain,
        table_for)
    from repro_torch.kernels.activation.ref import activation_out_dtype
    from repro_torch.kernels.activation.vpu_exact import (THREADS, VECS,
                                                          walk_plan)
    dev = torch.device("cuda")
    sms = cuda.sm_count(dev)
    out = (ctypes.c_longlong * 4)()
    queries = 0
    for dtype in CUDA_DTYPES:
        size = torch.empty((), dtype=dtype).element_size()
        osize = activation_out_dtype(dtype).itemsize
        tile = THREADS * VECS * (16 // size)
        numels = (0, 1, 15, tile - 1, tile, tile + 1, 40 * tile + 5,
                  sms * 16 * tile + 7)
        for off in range(16):
            for numel in numels:
                for yoff, cards in ((0, sms), (osize, 1)):
                    kw = dict(itemsize=size, out_itemsize=osize,
                              x_addr=4096 + off, y_addr=8192 + yoff,
                              sms=cards)
                    try:
                        want = walk_plan(numel, **kw)
                    except ValueError:
                        want = None
                    err = cuda.lib().cnn_activation_plan(
                        cuda.DTYPE_CODE[dtype], 4096 + off, 8192 + yoff,
                        numel, cards, out)
                    got = None if err else (out[0], bool(out[1]), out[2],
                                            out[3])
                    check(got == (None if want is None else tuple(want)),
                          f"activation walk {dtype} +{off} B numel {numel} "
                          f"sms {cards}: C {got}, walk_plan {want}")
                    queries += 1
        base = torch.randn(numels[-2] + 16, generator=gen) * 5
        base[:3] = torch.tensor([float("nan"), float("inf"),
                                 -float("inf")])
        if not dtype.is_floating_point:
            base = (base.nan_to_num(0.0, 0.0, 0.0) * 20).round().clamp(
                -128, 127)
        base = base.to(dtype).to(dev)
        for off in range(0, 16, size):
            for numel in numels[:-1]:
                x = base[off // size:off // size + numel]
                check(numel == 0 or x.data_ptr() % 16 == off,
                      "LUT input offset")
                for kind in sorted(RANGES):
                    what = f"activation_lut {dtype} +{off} B {numel} {kind}"
                    if numel == 0:
                        cuda.reset_launches()
                        check(activation_lut(x, kind=kind).numel() == 0
                              and cuda.launch_counts() == {}, what)
                        continue
                    got = launched_once(lambda: activation_lut(x, kind=kind),
                                        "activation_lut", what)
                    compare("activation_lut", got,
                            activation_lut_plain(x, kind=kind), 0, 0, errs,
                            exact=True)
                    if dtype.is_floating_point and off == 0 and numel > 2:
                        ends = table_for(kind, dev)[[0, 255, 0]].to(
                            got.dtype)
                        check(torch.equal(got[:3], ends),
                              f"{what}: NaN / +inf / -inf not on entries "
                              f"0 / 255 / 0")
    log(f"activation_lut (activation_lut_kernel on act_walk): the C split "
        f"equals walk_plan in {queries} queries; bitwise equal to the plain "
        f"version on {[str(d) for d in CUDA_DTYPES]} at every aligned "
        f"byte offset 0-15, numels 0, 1, 15, a tile +-1 and 40 tiles, "
        f"every kind, NaN / +-inf on the end entries")
    torch.cuda.synchronize()


def conv4_ragged_checks(shapes, gen, errs):
    """conv2d_ip4 (conv2d_ip2's tiled kernel with two streams) at
    CONV_RAGGED and both block shapes, on f32, int8, int16 and bf16
    (integers over their full range), at block_cout 1, 5, 16 and 128:
    one launch a call, results independent of block_cout; each f32 and
    int8 stream bitwise equal to a conv2d_ip2 launch on it; integers
    exact and floats within rtol=1e-4, atol=1e-5 of the plain version."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.kernels.conv2d.inner import tile_plan
    from repro_torch.kernels.conv2d.ip2_mxu import conv2d_ip2
    from repro_torch.kernels.conv2d.ip4_dual import (conv2d_ip4,
                                                     conv2d_ip4_plain)
    plans = []
    for xs, ws in CONV_RAGGED + tuple(shapes.values()):
        scale = (ws[0] * ws[1] * ws[2]) ** -0.5
        for dtype in (torch.float32, torch.int8, torch.int16,
                      torch.bfloat16):
            xa, xb = operand(gen, xs, dtype), operand(gen, xs, dtype)
            w = operand(gen, ws, dtype, scale)
            what = f"conv2d_ip4 {dtype} at {xs} x {ws}"
            ys = None
            for bc in (128, 16, 5, 1):
                cuda.reset_launches()
                got = conv2d_ip4(xa, xb, w, block_cout=bc)
                check(cuda.launch_counts() == {"conv2d_ip4": 1},
                      f"{what}, block_cout {bc}: launches "
                      f"{cuda.launch_counts()}, expected 1")
                if ys is None:
                    ys = got
                check(all(torch.equal(u, v) for u, v in zip(got, ys)),
                      f"{what}: result depends on block_cout ({bc})")
            exact = not dtype.is_floating_point
            for got, want in zip(ys, conv2d_ip4_plain(xa, xb, w)):
                compare("conv2d_ip4", got, want, 1e-4, 1e-5, errs,
                        exact=exact)
            if dtype in (torch.float32, torch.int8):
                check(torch.equal(ys[0], conv2d_ip2(xa, w))
                      and torch.equal(ys[1], conv2d_ip2(xb, w)),
                      f"{what}: not bitwise equal to two conv2d_ip2 "
                      f"launches")
            n, h, w_, cin = xs
            plans.append(tile_plan(h, w_, cin, *ws[:2], ws[3],
                                   itemsize=xa.element_size(), style="mxu",
                                   streams=2))
    log(f"conv2d_ip4 ({KERNEL['conv2d_ip4']}, two streams, one launch a "
        f"call) at {len(CONV_RAGGED)} ragged shapes and both blocks, f32, "
        f"int8, int16, bf16, block_cout 1/5/16/128: integers exact, floats "
        f"within rtol=1e-4, atol=1e-5, f32 and int8 streams == conv2d_ip2 "
        f"bitwise; tile plans {plans}")
    torch.cuda.synchronize()


def ladder_kernel_checks(gen, errs):
    """The precision ladder's two kernels against their plain versions:
    the LUT activation bit-exact (f32 with NaN, +-inf and exact
    half-step ties; int8; int32) at the served shapes, and the im2col
    pool at the ``pool2d(budget=)`` shape (f32 within 1e-6, integers
    bit-exact with negative sums for the floor average)."""
    import torch
    from repro_torch.kernels.activation.lut_poly import (
        RANGES, activation_lut, activation_lut_plain, lut_scale)
    from repro_torch.kernels.pool2d.mxu_im2col import (pool2d_im2col,
                                                       pool2d_im2col_plain)
    from repro_torch.kernels.pool2d.vpu_window import pool2d_window
    dev = torch.device("cuda")
    for shape in ((4, 54, 54, 32), (4, 111, 111, 16)):
        x = torch.randn(shape, generator=gen) * 5
        flat = x.view(-1)
        flat[:3] = torch.tensor([float("nan"), float("inf"),
                                 -float("inf")])
        for kind in sorted(RANGES):
            r, s = RANGES[kind], lut_scale(kind)
            k = torch.arange(0, 255, dtype=torch.float32)
            ties = (k + 0.5) / s - r              # (x + r) * s == k + 0.5
            ties = ties[(ties + r) * s == k + 0.5]
            check(ties.numel() > 100, f"{kind}: too few exact ties")
            xt = x.clone()
            xt.view(-1)[3:3 + ties.numel()] = ties
            xt = xt.to(dev)
            compare("activation_lut", activation_lut(xt, kind=kind),
                    activation_lut_plain(xt, kind=kind), 0, 0, errs,
                    exact=True)
            for dtype, lo, hi in ((torch.int8, -128, 127),
                                  (torch.int32, -50, 50)):
                xi = torch.randint(lo, hi, shape, generator=gen,
                                   dtype=dtype).to(dev)
                compare("activation_lut", activation_lut(xi, kind=kind),
                        activation_lut_plain(xi, kind=kind), 0, 0, errs,
                        exact=True)
        check(torch.equal(activation_lut(xt, block_rows=7),
                          activation_lut(xt)),
              "activation_lut: result depends on block_rows")
    shape = (4, 222, 222, 16)
    xf = torch.randn(shape, generator=gen).to(dev)
    xi8 = torch.randint(-128, 127, shape, generator=gen,
                        dtype=torch.int8).to(dev)
    xi32 = torch.randint(-1000, 1000, shape, generator=gen,
                         dtype=torch.int32).to(dev)
    for mode in ("max", "avg"):
        compare("pool2d_im2col", pool2d_im2col(xf, mode=mode),
                pool2d_im2col_plain(xf, mode=mode), 1e-6, 1e-6, errs)
        for t in (xi8, xi32):
            got = pool2d_im2col(t, mode=mode)
            compare("pool2d_im2col", got,
                    pool2d_im2col_plain(t, mode=mode), 0, 0, errs,
                    exact=True)
            if mode == "avg":
                check(bool((got < 0).any()), "no negative average")
        check(torch.equal(pool2d_im2col(xf, mode=mode, block_c=3),
                          pool2d_im2col(xf, mode=mode)),
              "pool2d_im2col: result depends on block_c")
        for t in (xf, xi8, xi32):
            check(torch.equal(pool2d_im2col(t, mode=mode),
                              pool2d_window(t, mode=mode)),
                  f"pool2d_im2col {t.dtype} {mode}: not bitwise "
                  f"pool2d_window")
    xn = xf.clone()
    xn[0, 0, 0, 0] = float("nan")
    check(bool(torch.isnan(pool2d_im2col(xn)[0, 0, 0, 0])),
          "pool2d_im2col: max dropped a NaN")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Phase 4: serving
# ---------------------------------------------------------------------------
def serve(device, fuse, requests, seed=SEED, dtype="float32",
          autotune=False):
    import torch
    from repro_torch.runtime.server import AdaptiveServer
    from repro_torch.core.plan import clear_plan_cache
    clear_plan_cache()
    srv = AdaptiveServer(device=device, fuse=fuse, max_batch=MAX_BATCH,
                         autotune=autotune)
    params = frontend_params(dtype, srv.device, seed)
    srv.register("cnn", params, IMAGE)
    for x in requests:
        srv.submit("cnn", x)
    done = srv.drain()
    if srv.device.type == "cuda":
        torch.cuda.synchronize()
    return srv, sorted(done, key=lambda c: c.rid)


# The frontend's other tenants (PR 21): bf16 images and weights
# (init_cnn_frontend(dtype=torch.bfloat16)), and int16 images in
# [-100, 100] with weights in [-8, 8] and projection in [-4, 4] (an int16
# init would round N(0, 1/27) draws to zero): block 0 sums exactly in
# int32, block 1 takes its f32 input against the int16 weights.
FRONTEND_DTYPES = ("bfloat16", "int16")


def frontend_params(dtype, device, seed=SEED):
    """The default frontend's params in ``dtype``, seeded."""
    import numpy as np
    import torch
    from repro_torch.models.frontends import (init_cnn_frontend,
                                              params_from_numpy)
    if dtype != "int16":
        return init_cnn_frontend(seed, dtype=getattr(torch, dtype),
                                 device=device)
    rng = np.random.default_rng(seed)
    return params_from_numpy(
        {"blocks": [{"w": rng.integers(-8, 9, s).astype(np.int16)}
                    for s in ((3, 3, 3, 16), (3, 3, 16, 32))],
         "proj": rng.integers(-4, 5, (32, 64)).astype(np.int16)}, device)


def frontend_requests(dtype):
    """N_REQUESTS seeded 224x224x3 samples in ``dtype``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 1)
    if dtype == "int16":
        return [rng.integers(-100, 101, IMAGE).astype(np.int16)
                for _ in range(N_REQUESTS)]
    return [torch.from_numpy(rng.normal(size=IMAGE).astype(np.float32))
            .to(getattr(torch, dtype)) for _ in range(N_REQUESTS)]


def serve_dtype_checks():
    """Each of FRONTEND_DTYPES served through AdaptiveServer(device=
    "cuda"), fused and unfused (counters reset just before, read just
    after each), against a device="cpu" server: f32 results within
    rtol=1e-4, atol=1e-5, fused == unfused bitwise, equal accounting;
    int16's integer intermediates exact (block 0's output, through both
    plans, bitwise equal to the CPU's)."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.models.blocks import apply_cnn_block
    fused_set = {"fused_cnn_vpu", "fused_cnn_mxu"}
    chain_set = {"conv2d_ip1", "conv2d_ip2", "pool2d_window",
                 "pool2d_im2col", "activation_exact", "activation_lut"}
    for dtype in FRONTEND_DTYPES:
        requests = frontend_requests(dtype)
        runs = {}
        for fuse in (True, False):
            cuda.reset_launches()
            _, done = serve("cuda", fuse, requests, dtype=dtype)
            counts = cuda.launch_counts()
            check(bool(counts) and set(counts) <= (fused_set if fuse
                                                   else chain_set),
                  f"{dtype} fuse={fuse}: launched {counts}")
            check(len(done) == N_REQUESTS and all(
                tuple(c.result.shape) == LADDER_OUT and c.result.is_cuda
                and c.result.dtype == torch.float32
                and bool(torch.isfinite(c.result).all()) for c in done),
                  f"{dtype} fuse={fuse}: bad completions")
            runs[fuse] = (done, counts)
        for a, b in zip(runs[True][0], runs[False][0]):
            check(torch.equal(a.result, b.result),
                  f"{dtype} rid {a.rid}: fused and unfused serving differ")
        _, cpu_done = serve("cpu", True, requests, dtype=dtype)
        for a, b in zip(runs[True][0], cpu_done):
            torch.testing.assert_close(a.result.cpu(), b.result, rtol=1e-4,
                                       atol=1e-5)
            check((a.rid, a.batch_size, a.finished) ==
                  (b.rid, b.batch_size, b.finished),
                  f"{dtype} rid {a.rid}: accounting differs from the CPU "
                  f"server")
        if dtype == "int16":
            params = frontend_params(dtype, "cuda")
            x = torch.stack([torch.from_numpy(r) for r in
                             requests[:MAX_BATCH]])
            want = apply_cnn_block(frontend_params(dtype, "cpu")["blocks"][0],
                                   x, site="frontend.block0")
            for fuse in (True, False):
                got = apply_cnn_block(params["blocks"][0], x.cuda(),
                                      site="frontend.block0", fuse=fuse)
                check(torch.equal(got.cpu(), want),
                      f"int16 block 0 (fuse={fuse}): not bitwise equal to "
                      f"the CPU's")
        log(f"{dtype} frontend: {N_REQUESTS} requests served on the card "
            f"fused (launches {runs[True][1]}) and unfused (launches "
            f"{runs[False][1]}), bitwise equal; the device='cpu' server "
            f"agrees within rtol=1e-4, atol=1e-5, accounting equal"
            + ("; block 0's integer path bitwise equal to the CPU's"
               if dtype == "int16" else ""))


def serve_checks():
    import numpy as np
    import torch
    from repro_torch.core.plan import replan
    from repro_torch.kernels import cuda

    rng = np.random.default_rng(SEED)
    requests = [rng.normal(size=IMAGE).astype(np.float32)
                for _ in range(N_REQUESTS)]
    launches = {}

    cuda.reset_launches()
    srv, fused_done = serve(None, True, requests)   # device=None: cuda
    launches.update(cuda.launch_counts())
    check(srv.device.type == "cuda", "server did not default to cuda")
    check(len(fused_done) == N_REQUESTS, f"{len(fused_done)} completions")
    for c in fused_done:
        check(tuple(c.result.shape) == (2916, 64),
              f"rid {c.rid}: result {tuple(c.result.shape)}")
        check(c.result.is_cuda and bool(torch.isfinite(c.result).all()),
              f"rid {c.rid}: non-finite or off-card result")
    tenant = srv.tenants["cnn"]
    for specs in srv._specs_cache.values():      # one per batch shape
        members = [s.ip.name for s in replan(
            specs, srv.budget.scaled(tenant.granted)).sites]
        check(members == ["cnn_fused.fused_vpu", "cnn_fused.fused_mxu"],
              f"served plan {members}")
    check(set(launches) == {"fused_cnn_vpu", "fused_cnn_mxu"},
          f"fused plan launched {launches}")
    log(f"fuse=True: {len(fused_done)} requests through {members}; "
        f"launches {launches}")

    cuda.reset_launches()
    _, chain_done = serve("cuda", False, requests)
    chain = cuda.launch_counts()
    check(set(chain) == {"conv2d_ip1", "conv2d_ip2", "pool2d_window",
                         "activation_exact"},
          f"fuse=False plan launched {chain}")
    launches.update(chain)
    for a, b in zip(fused_done, chain_done):
        check(torch.equal(a.result, b.result),
              f"rid {a.rid}: fused and unfused serving differ")
    log(f"fuse=False: bitwise equal to fuse=True; launches {chain}")

    _, cpu_done = serve("cpu", True, requests)
    for a, b in zip(fused_done, cpu_done):
        torch.testing.assert_close(a.result.cpu(), b.result, rtol=1e-4,
                                   atol=1e-5)
        check((a.rid, a.batch_size, a.finished) ==
              (b.rid, b.batch_size, b.finished),
              f"rid {a.rid}: est-cycle accounting differs from the CPU "
              f"server")
    log("device='cpu' server (plain versions) agrees within "
        "rtol=1e-4, atol=1e-5; est-cycle latencies equal")
    return launches, requests


def ladder_trace(seed=SEED):
    """LADDER_WAVES waves of LADDER_MIX requests, seeded."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [[(name, rng.normal(size=IMAGE).astype(np.float32))
             for name, n in LADDER_MIX.items() for _ in range(n)]
            for _ in range(LADDER_WAVES)]


def ladder_server(name, device, calibration=None):
    """A deployment of LADDER: the default frontend as the f32 relu
    "heavy" tenant and, from the next seed, the tanh "light" tenant with
    the (16, 8) ladder and measured quantization error; planned and
    priced by ``calibration`` when given."""
    from repro_torch.core.plan import clear_plan_cache
    from repro_torch.core.resources import ResourceBudget
    from repro_torch.models.frontends import init_cnn_frontend
    from repro_torch.runtime.server import AdaptiveServer
    budget, fuse, _, _ = LADDER[name]
    clear_plan_cache()
    srv = AdaptiveServer(ResourceBudget(**budget), policy="demand",
                         max_batch=MAX_BATCH, fuse=fuse, device=device,
                         calibration=calibration)
    srv.register("heavy", init_cnn_frontend(SEED, device=device), IMAGE)
    srv.register("light", init_cnn_frontend(SEED + 1, device=device), IMAGE,
                 activation="tanh", ladder=(16, 8), measure_quant=True)
    return srv


def run_trace(srv, trace):
    """Submit each wave, then ``step()``.  Returns the completions by rid
    and each step's grants."""
    import torch
    done, grants = [], []
    for wave in trace:
        for tenant, x in wave:
            srv.submit(tenant, x)
        done += srv.step()
        grants.append({k: v.fraction for k, v in srv.shares().items()})
    if srv.device.type == "cuda":
        torch.cuda.synchronize()
    return sorted(done, key=lambda c: c.rid), grants


def light_plans(srv, grants):
    """The light tenant's plan at batch 2 under each step's grant."""
    from repro_torch.core.plan import replan
    t = srv.tenants["light"]
    specs = srv._specs(t.params, (LADDER_MIX["light"],) + IMAGE, "float32",
                       t.pool_window, t.activation, t.ladder)
    return [[f"{s.ip.name}@{s.precision_bits}"
             for s in replan(specs, srv.budget.scaled(g["light"]),
                             fuse=srv.fuse).sites] for g in grants]


def code_flip_step(params, images):
    """One step of the coarsest grid feeding an output of the light
    tenant: a flipped int8 code of the last block's input (times its
    largest weight and taps), of its conv output or of its pooled value
    (tanh is 1-Lipschitz), plus one table step of the LUT — times the
    largest column sum of the projection (each output sums one feature
    per channel).  The last block's input comes from the f32 frontend on
    the card."""
    import torch
    from repro_torch.kernels.activation.lut_poly import RANGES, TABLE_SIZE
    from repro_torch.kernels.conv2d.ref import conv2d_ref
    from repro_torch.kernels.pool2d.ref import pool2d_ref
    from repro_torch.models.blocks import apply_cnn_block
    x = images
    for bp in params["blocks"][:-1]:
        x = apply_cnn_block(bp, x, activation="tanh")
    w = params["blocks"][-1]["w"]
    conv = conv2d_ref(x, w)
    pool = pool2d_ref(conv)
    step = (float(x.abs().max() * w.abs().max()) * w.shape[0] * w.shape[1]
            + float(conv.abs().max()) + float(pool.abs().max())) / 127
    step += 2 * RANGES["tanh"] / (TABLE_SIZE - 1)
    return step * float(params["proj"].abs().sum(dim=0).max())


def code_flip(name, got, want, step):
    """At most FLIP_SHARE of the elements out of rtol=1e-4, atol=1e-5,
    each by at most ``step``.  Returns the count out of tolerance."""
    import torch
    diff = (got.double() - want.double()).abs()
    bad = diff > 1e-5 + 1e-4 * want.double().abs()
    n_bad = int(bad.sum())
    check(n_bad <= FLIP_SHARE * bad.numel(),
          f"{name}: {n_bad} of {bad.numel()} elements out of tolerance")
    check(n_bad == 0 or float(diff[bad].max()) <= step + 1e-5,
          f"{name}: an element moved {float(diff.max())} > one grid step "
          f"{step}")
    return n_bad


def ladder_serve_checks(trace):
    """Serve each LADDER deployment on the card (counters reset just
    before, read just after) and on the CPU; returns the launches of
    each deployment's run and its light tenant's measured error."""
    import torch
    from repro_torch.kernels import cuda
    out = {}
    for name, (_, _, plan, kernel) in LADDER.items():
        srv = ladder_server(name, None)                # device=None: cuda
        cuda.reset_launches()
        done, grants = run_trace(srv, trace)
        launches = cuda.launch_counts()
        check(srv.device.type == "cuda", "server did not default to cuda")
        check(kernel in launches, f"{name}: {kernel} never launched "
                                  f"({launches})")
        plans = light_plans(srv, grants)
        check(all(p == plan for p in plans),
              f"{name}: light tenant planned {plans}, expected {plan}")
        n = LADDER_WAVES * sum(LADDER_MIX.values())
        check(len(done) == n, f"{name}: {len(done)} completions of {n}")
        for c in done:
            check(tuple(c.result.shape) == LADDER_OUT and c.result.is_cuda
                  and bool(torch.isfinite(c.result).all()),
                  f"{name} rid {c.rid}: {tuple(c.result.shape)} "
                  f"{c.result.device}, or non-finite")
        tel = srv.telemetry()
        err = tel["light"]["max_quant_rel_err"]
        check(0.0 < err <= MAX_QUANT_ERR,
              f"{name}: light max_quant_rel_err {err}")
        log(f"{name}: {n} requests; light plan {plan}; grants "
            f"{grants[-1]}; launches {launches}; light max_quant_rel_err "
            f"{err:.4e}; precision_mix {tel['light']['precision_mix']}")

        cpu = ladder_server(name, "cpu")
        cpu_done, cpu_grants = run_trace(cpu, trace)
        check([(c.rid, c.tenant, c.batch_size, c.finished) for c in done]
              == [(c.rid, c.tenant, c.batch_size, c.finished)
                  for c in cpu_done],
              f"{name}: rids, batch sizes or est-cycle finish times differ "
              f"from the CPU server")
        check(grants == cpu_grants, f"{name}: grants {grants} vs CPU "
                                    f"{cpu_grants}")
        cpu_tel = cpu.telemetry()
        for t in ("heavy", "light"):
            check(tel[t]["precision_mix"] == cpu_tel[t]["precision_mix"],
                  f"{name} {t}: precision_mix differs from the CPU server")
        light = torch.stack([torch.as_tensor(x) for wave in trace
                             for t, x in wave if t == "light"]).cuda()
        steps = {"heavy": 0.0,
                 "light": code_flip_step(srv.tenants["light"].params,
                                         light)}
        flips = [code_flip(f"{name} rid {a.rid}", a.result.cpu(),
                           b.result, steps[a.tenant])
                 for a, b in zip(done, cpu_done)]
        size = done[0].result.numel()
        log(f"{name}: CPU server accounting equal; results within the "
            f"code-flip rule ({sum(flips)} elements out of rtol=1e-4, "
            f"atol=1e-5 over {len(done)} completions, at most "
            f"{max(flips)} of {size} in one, "
            f"{max(flips) / size:.4%}; light grid step "
            f"{steps['light']:.4e})")
        out[name] = (launches, err)
    return out


# ---------------------------------------------------------------------------
# "slo": the SLO scheduler (runtime/scheduler.py) on the card
# ---------------------------------------------------------------------------
# The deployment of benchmarks/run.py::_slo_deployment at the default
# frontend's full width: ladder_fused's budget, max_batch 4, grants on a
# 1/16 grid; "heavy" the f32 relu frontend at priority 0, "light" the tanh
# frontend with the (16, 8) ladder at priority 1.
SLO_BUDGET = LADDER["ladder_fused"][0]
SLO_QUANTUM = 1 / 16
SLO_PRESSURE = 2.0
SLO_PRIORITY = {"heavy": 0, "light": 1}
SLO_TENANT_KW = {"heavy": {}, "light": dict(activation="tanh",
                                            ladder=(16, 8))}
# table_slo's first mix and constants (benchmarks/run.py:952-963):
# deadlines and mean inter-arrivals in units.  In (b) the unit is the
# card's warm batch-4 round wall time; in (a) deadlines are seconds of a
# wall that moves only when told and arrivals are in units of heavy's
# one-request est-cycles, and two edge cases follow the trace.
SLO_MIX = {"heavy": 16, "light": 6}
SLO_DEADLINE_UNITS = {"heavy": 30.0, "light": 2.0}
SLO_IAT_UNITS = {"heavy": 1 / 4.5, "light": 1.0}
SLO_SHED_BURST = 6         # light requests at once: 4 launch, 2 are shed
SLO_REJECT_BURST = 5       # light requests against max_queue_depth 2
SLO_WARMUPS = 6            # replays an arm at most, until one plans no miss
SLO_REPLAYS = 5
# (c) head dims the attention kernels are not built for, at (B, Hq, Hkv,
# Sq, Skv), and the input ROADMAP queue 3 named: (1,4,64,8) x (1,2,64,8)
HEAD_DIM_CHECKS = (8, 12, 80)
HEAD_DIM_SHAPE = (2, 8, 2, 70, 100)
HEAD_DIM_SITE = ((1, 4, 64, 8), (1, 2, 64, 8))
# the kernel each planned CNN member launches
CNN_MEMBER_KERNEL = {"cnn_fused.fused_vpu": "fused_cnn_vpu",
                     "cnn_fused.fused_mxu": "fused_cnn_mxu",
                     "conv2d.ip1_vpu": "conv2d_ip1",
                     "conv2d.ip2_mxu": "conv2d_ip2",
                     "pool2d.pool_vpu": "pool2d_window",
                     "pool2d.pool_im2col": "pool2d_im2col",
                     "activation.act_vpu": "activation_exact",
                     "activation.act_lut": "activation_lut"}


class ManualWall:
    """A wall clock that moves only when told (seconds)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def slo_server(device, slo_pressure=SLO_PRESSURE):
    """The SLO deployment's server (``_slo_deployment``) on ``device`` and
    its two tenants' frontends."""
    from repro_torch.core.resources import ResourceBudget
    from repro_torch.models.frontends import init_cnn_frontend
    from repro_torch.runtime import AdaptiveServer
    srv = AdaptiveServer(ResourceBudget(**SLO_BUDGET), policy="demand",
                         max_batch=MAX_BATCH, slo_pressure=slo_pressure,
                         grant_quantum=SLO_QUANTUM, device=device)
    params = {"heavy": init_cnn_frontend(SEED, device=srv.device),
              "light": init_cnn_frontend(SEED + 1, device=srv.device)}
    return srv, params


def slo_scheduler(device, wall, deadlines):
    """The deployment under an ``SLOScheduler`` reading ``wall``."""
    from repro_torch.core.plan import clear_plan_cache
    from repro_torch.runtime import SLOScheduler, SLOSpec
    clear_plan_cache()
    srv, params = slo_server(device)
    sched = SLOScheduler(srv, wall=wall)
    for name in ("heavy", "light"):
        sched.register(name, params[name], IMAGE, **SLO_TENANT_KW[name],
                       slo=SLOSpec(deadline_s=deadlines[name],
                                   priority=SLO_PRIORITY[name]))
    return sched


def launch_kernels(srv, tenant, batch):
    """A batch's plan under the tenant's grant: its sites as member@bits
    and the kernels they launch, counted."""
    from repro_torch.core.plan import replan
    t = srv.tenants[tenant]
    specs = srv._specs(t.params, (batch,) + IMAGE, "float32", t.pool_window,
                       t.activation, t.ladder)
    plan = replan(specs, srv.budget.scaled(t.granted), fuse=srv.fuse)
    want = {}
    for s in plan.sites:
        k = CNN_MEMBER_KERNEL[s.ip.name]
        want[k] = want.get(k, 0) + 1
    return plan_str(plan), want


def slo_parity_run(device, trace):
    """(a) Drive the deployment on ``device`` through the trace one
    launch at a time (on the card, counters reset just before each launch
    and read just after: it must run the kernels its plan names), then
    the shed case (a light burst, one launch, the wall moved past the
    rest's deadline) and the rejection case (``max_queue_depth=2`` set
    through ``load_state``, a larger burst).  Returns the scheduler, its
    completions, the grants after each launch, each launch's (tenant,
    batch, counters) and every light sample."""
    import numpy as np
    import torch
    from repro_torch.kernels import cuda
    wall = ManualWall()
    sched = slo_scheduler(device, wall, SLO_DEADLINE_UNITS)
    srv = sched.server
    unit = srv.tenants["heavy"].unit_cost
    for at, name, x in trace:
        sched.submit(name, x, at=at * unit)
    done, grants, runs = [], [], []

    def one_launch():
        before = sched.launches
        cuda.reset_launches()
        got = sched.run(max_launches=sched.launches + 1)
        counts = cuda.launch_counts()
        if sched.launches == before:
            check(not got, "slo: a run without a launch completed requests")
            return
        done.extend(got)
        grants.append({k: v.fraction
                       for k, v in srv.arbiter.shares().items()})
        plan, want = launch_kernels(srv, got[0].tenant, len(got))
        runs.append((got[0].tenant, len(got), plan, counts))
        if srv.device.type == "cuda":
            check(counts == want, f"slo launch {sched.launches}: launched "
                                  f"{counts}, its plan {plan} names {want}")

    def drain():
        while sched.pending():
            one_launch()

    drain()
    rng = np.random.default_rng(SEED + 3)
    burst = [rng.normal(size=IMAGE).astype(np.float32)
             for _ in range(SLO_SHED_BURST + SLO_REJECT_BURST)]
    for x in burst[:SLO_SHED_BURST]:
        sched.submit("light", x)
    one_launch()
    check(sched.pending() > 0, "slo shed case: nothing left queued")
    wall.t += SLO_DEADLINE_UNITS["light"] + 1.0    # past the queued deadline
    drain()
    state = sched.state_dict()
    state["slos"]["light"]["max_queue_depth"] = 2
    sched.load_state(state)
    for x in burst[SLO_SHED_BURST:]:
        sched.submit("light", x)
    drain()
    if srv.device.type == "cuda":
        torch.cuda.synchronize()
    light = [x for _, name, x in trace if name == "light"] + burst
    return sched, done, grants, runs, light


def slo_metric_lines(sched):
    return [line for line in sched.metrics().render().splitlines()
            if "repro_tenant_" in line or "repro_scheduler_" in line]


def slo_parity_checks(card):
    """(a): the card's scheduler against the device="cpu" scheduler's."""
    import numpy as np
    import torch
    trace = slo_trace(np.random.default_rng(SEED + 2), 1.0, from_zero=True)
    sched, done, grants, runs, light = slo_parity_run(None, trace)
    srv = sched.server
    check(srv.device.type == "cuda", "slo: the server did not default to "
                                     "cuda")
    cpu, cpu_done, cpu_grants, cpu_runs, _ = slo_parity_run("cpu", trace)
    st = sched.stats()
    check(st == cpu.stats(), f"slo: stats {st} vs CPU {cpu.stats()}")
    check(sched.outcomes == cpu.outcomes, "slo: outcomes differ from the "
                                          "CPU scheduler's")
    check([(c.rid, c.tenant, c.finished, c.batch_size) for c in done]
          == [(c.rid, c.tenant, c.finished, c.batch_size)
              for c in cpu_done],
          "slo: completions (rid, tenant, finished, batch) differ from the "
          "CPU scheduler's")
    check(grants == cpu_grants, f"slo: grants {grants} vs CPU {cpu_grants}")
    check([r[:3] for r in runs] == [r[:3] for r in cpu_runs],
          "slo: launch order or plans differ from the CPU scheduler's")
    for name in ("heavy", "light"):
        check(srv.arbiter.miss_rate(name)
              == cpu.server.arbiter.miss_rate(name),
              f"slo: {name}'s miss rate differs from the CPU scheduler's")
    check(st["preemptions"] >= 1 and st["sheds"] >= 1
          and st["rejections"] >= 1,
          f"slo: the trace must preempt, shed and reject: {st}")
    check(slo_metric_lines(sched) == slo_metric_lines(cpu),
          "slo: tenant_/scheduler_ metrics lines differ from the CPU's")
    step = code_flip_step(srv.tenants["light"].params,
                          torch.stack([torch.as_tensor(x)
                                       for x in light]).cuda())
    flips = 0
    for a, b in zip(done, cpu_done):
        check(tuple(a.result.shape) == LADDER_OUT and a.result.is_cuda
              and bool(torch.isfinite(a.result).all()),
              f"slo rid {a.rid}: {tuple(a.result.shape)} {a.result.device}, "
              f"or non-finite")
        if a.tenant == "heavy":
            torch.testing.assert_close(a.result.cpu(), b.result, rtol=1e-4,
                                       atol=1e-5)
        else:
            flips += code_flip(f"slo rid {a.rid}", a.result.cpu(), b.result,
                               step)
    total = {}
    for *_, counts in runs:
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    check({"fused_cnn_vpu", "fused_cnn_mxu"} <= set(total),
          f"slo: the fused kernels never launched ({total})")
    log(f"slo (a): {len(done)} completions in {st['launches']} launches on "
        f"the card == the device='cpu' scheduler (outcomes, stats, "
        f"completions, grants after each launch, miss rates, tenant_/"
        f"scheduler_ metrics lines); stats {st}; heavy within rtol=1e-4, "
        f"atol=1e-5, light under the code-flip rule ({flips} elements "
        f"out); each launch ran its plan's kernels: {total}; launches "
        f"(tenant, batch, plan) {[r[:3] for r in runs]}; grants after each "
        f"launch {grants}; on {card}")


def slo_trace(rng, unit, from_zero=False):
    """table_slo's trace (``_slo_trace``): per tenant Poisson arrivals
    at SLO_IAT_UNITS times ``unit``, both tenants at 224x224x3, as (at,
    tenant, sample) in arrival order.  ``from_zero`` puts each tenant's
    first arrival at 0: heavy's bucket opens first and the light one
    preempts it."""
    import numpy as np
    arrivals = []
    for name, n in SLO_MIX.items():
        t = 0.0
        for _ in range(n):
            gap = float(rng.exponential(SLO_IAT_UNITS[name] * unit))
            arrivals.append((t if from_zero else t + gap, name))
            t += gap
    arrivals.sort(key=lambda pair: pair[0])
    return [(at, name, rng.normal(size=IMAGE).astype(np.float32))
            for at, name in arrivals]


def slo_unit_seconds():
    """The card's warm batch-4 round (4 heavy + 2 light requests, one
    ``step``, synchronized inside the timed region): the median of the
    rounds after the first (``_slo_unit_seconds``)."""
    import numpy as np
    import torch
    from repro_torch.core.plan import clear_plan_cache
    clear_plan_cache()
    srv, params = slo_server("cuda", slo_pressure=0.0)
    for name in ("heavy", "light"):
        srv.register(name, params[name], IMAGE, **SLO_TENANT_KW[name])
    rng = np.random.default_rng(7)
    times = []
    for _ in range(3):
        for name, n in (("heavy", 4), ("light", 2)):
            for _ in range(n):
                srv.submit(name, rng.normal(size=IMAGE).astype(np.float32))
        t0 = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times[1:])


def slo_replay(samples, deadlines, submit, pump, pending, outcomes=None):
    """``_slo_replay`` on the card: arrivals land on the real clock, each
    request is judged from its scheduled arrival, and every pump is
    synchronized before its completions are stamped.  Returns per-tenant
    wall latencies, misses, served and dropped."""
    import torch
    lat = {name: [] for name in deadlines}
    missed = {name: 0 for name in deadlines}
    arrival_s, tenant_of = {}, {}
    i = 0
    t0 = time.monotonic()
    while i < len(samples) or pending():
        now = time.monotonic() - t0
        while i < len(samples) and samples[i][0] <= now:
            at_s, name, x = samples[i]
            rid = submit(name, x)
            arrival_s[rid] = at_s
            tenant_of[rid] = name
            i += 1
        if pending():
            comps = pump()
            torch.cuda.synchronize()
            done = time.monotonic() - t0
            for c in comps:
                wall = done - arrival_s[c.rid]
                lat[c.tenant].append(wall)
                if wall > deadlines[c.tenant]:
                    missed[c.tenant] += 1
        elif i < len(samples):
            time.sleep(max(0.0, min(samples[i][0] - now, 0.01)))
    if outcomes is not None:
        for rid, verdict in outcomes().items():
            if verdict in ("shed", "rejected"):
                missed[tenant_of[rid]] += 1
    served = sum(len(v) for v in lat.values())
    return lat, missed, served, len(arrival_s) - served


def slo_sync_arm(samples, deadlines):
    """The round loop: each ``AdaptiveServer.step`` drains every bucket."""
    srv, params = slo_server("cuda", slo_pressure=0.0)
    for name in ("heavy", "light"):
        srv.register(name, params[name], IMAGE, **SLO_TENANT_KW[name])
    out = slo_replay(samples, deadlines, submit=srv.submit, pump=srv.step,
                     pending=srv.pending)
    launches = sum(t.telemetry.batches for t in srv.tenants.values())
    return out + ({"launches": launches, "sheds": 0, "preemptions": 0},)


def slo_async_arm(samples, deadlines):
    """The SLO scheduler, one launch a pump, on the real wall clock."""
    from repro_torch.runtime import SLOScheduler, SLOSpec
    srv, params = slo_server("cuda")
    sched = SLOScheduler(srv)
    for name in ("heavy", "light"):
        sched.register(name, params[name], IMAGE, **SLO_TENANT_KW[name],
                       slo=SLOSpec(deadline_s=deadlines[name],
                                   priority=SLO_PRIORITY[name]))
    out = slo_replay(samples, deadlines, submit=sched.submit,
                     pump=lambda: sched.run(max_launches=sched.launches + 1),
                     pending=sched.pending, outcomes=lambda: sched.outcomes)
    return out + (sched.stats(),)


def slo_premise(card):
    """(b) table_slo's premise at full width on the card: the sync arm
    (the round loop) and the async arm (the scheduler) replay one Poisson
    trace; per arm the median over SLO_REPLAYS replays of the worst
    tenant's deadline-normalized p95 and of the miss rate, and the last
    replay's sheds, preemptions and launches.  Every replay must account
    for every request; which arm wins is logged, not checked."""
    import numpy as np
    from repro_torch.core.plan import STATS
    unit_s = slo_unit_seconds()
    deadlines = {name: SLO_DEADLINE_UNITS[name] * unit_s
                 for name in SLO_MIX}
    samples = slo_trace(np.random.default_rng(
        1000 + SLO_MIX["heavy"] * 31 + SLO_MIX["light"]), unit_s)
    n = len(samples)
    arms = {"sync": slo_sync_arm, "async": slo_async_arm}
    warm = {}
    for name, arm in arms.items():
        for i in range(SLO_WARMUPS):
            before = STATS.plan_misses
            arm(samples, deadlines)
            if STATS.plan_misses == before:
                break
        warm[name] = i + 1

    def worst_norm_p95(lat):
        return max(float(np.percentile(v, 95)) / deadlines[t]
                   for t, v in lat.items() if v)

    result = {}
    for name, arm in arms.items():
        p95s, misses = [], []
        for _ in range(SLO_REPLAYS):
            lat, missed, served, dropped, stats = arm(samples, deadlines)
            check(served + dropped == n,
                  f"slo {name}: {served} served + {dropped} dropped of {n}")
            p95s.append(worst_norm_p95(lat))
            misses.append(sum(missed.values()) / n)
        result[name] = (statistics.median(p95s), statistics.median(misses))
        log(f"slo (b) {name} arm: {warm[name]} warmup replays, then "
            f"{SLO_REPLAYS}: worst-tenant p95 / deadline per replay "
            f"{p95s}, miss rate per replay {misses}; median p95_norm "
            f"{result[name][0]!r}, median miss rate {result[name][1]!r}; "
            f"last replay: sheds {stats['sheds']}, preemptions "
            f"{stats['preemptions']}, launches {stats['launches']}; on "
            f"{card}")
    (p_sync, m_sync), (p_async, m_async) = result["sync"], result["async"]
    log(f"slo (b): unit (warm batch-4 round) {unit_s * 1e6:.1f} us, "
        f"deadlines heavy {deadlines['heavy'] * 1e3:.3f} ms, light "
        f"{deadlines['light'] * 1e3:.3f} ms, mix {SLO_MIX}; p95_norm sync "
        f"{p_sync!r} async {p_async!r}; miss rate sync {m_sync!r} async "
        f"{m_async!r}; async beats sync on p95: {p_async < p_sync}, on "
        f"misses: {m_async < m_sync} (logged, not checked); on {card}")


def head_dim_checks(card):
    """(c) The attention kernels at head dims they are not built for
    (zero-padded to the next width by ``flash.pad_head_dim``): each call
    launches once and matches its plain version; ``attention(budget=)``
    plans ROADMAP queue 3's input onto ``attn_flash`` / ``attn_decode``
    and computes (head dims past 128: "faults" (f))."""
    import torch
    from repro_torch.core.ip import SiteSpec
    from repro_torch.core.plan import plan_single
    from repro_torch.core.resources import ResourceBudget
    from repro_torch.kernels.attention.decode import (flash_decode,
                                                      flash_decode_plain)
    from repro_torch.kernels.attention.flash import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.attention.ops import attention
    gen = torch.Generator().manual_seed(SEED)
    errs = {}
    b, hq, hkv, sq, skv = HEAD_DIM_SHAPE
    for d in HEAD_DIM_CHECKS:
        for dtype, tol in ((torch.float32, ATTN_F32_TOL),
                           (torch.bfloat16, ATTN_BF16_TOL)):
            q = operand(gen, (b, hq, sq, d), dtype)
            k, v = (operand(gen, (b, hkv, skv, d), dtype) for _ in range(2))
            for causal in (True, False):
                got = launched_once(
                    lambda: flash_attention(q, k, v, causal=causal),
                    "flash_attention", f"flash_attention D={d} {dtype}")
                compare(f"flash_attention D={d} {dtype} causal={causal}",
                        got, flash_attention_plain(q, k, v, causal=causal),
                        errs=errs, **tol)
            q1 = q[:, :, :1].contiguous()
            got = launched_once(lambda: flash_decode(q1, k, v),
                                "flash_decode", f"flash_decode D={d} {dtype}")
            compare(f"flash_decode D={d} {dtype}", got,
                    flash_decode_plain(q1, k, v), errs=errs, **tol)
    qs, ks = HEAD_DIM_SITE
    q = operand(gen, qs, torch.float32)
    k, v = (operand(gen, ks, torch.float32) for _ in range(2))
    budget = ResourceBudget()
    for qq, member, kernel in ((q, "attn_flash", "flash_attention"),
                               (q[:, :, :1].contiguous(), "attn_decode",
                                "flash_decode")):
        spec = SiteSpec.make("attention", "attention", (qq.shape, k.shape),
                             qq.dtype)
        planned = plan_single(spec, budget).ip.name
        check(planned.endswith(member), f"attention(budget=) at "
                                        f"{tuple(qq.shape)}: planned "
                                        f"{planned}, not {member}")
        got = launched_once(lambda: attention(qq, k, v, budget=budget),
                            kernel, f"attention(budget=) {member}")
        plain = (flash_attention_plain(qq, k, v) if member == "attn_flash"
                 else flash_decode_plain(qq, k, v))
        compare(f"attention(budget=) {member} at {tuple(qq.shape)}", got,
                plain, errs=errs, **ATTN_F32_TOL)
    log(f"slo (c): flash_attention and flash_decode at head dims "
        f"{HEAD_DIM_CHECKS} (f32, bf16, causal and full, GQA {hq}/{hkv}) "
        f"one launch a call, within ATTN_F32_TOL / ATTN_BF16_TOL (max abs "
        f"err {max(errs.values()):.3e}); attention(budget=) at "
        f"{HEAD_DIM_SITE} planned and computed; on {card}")


# Head dims past 128 ("faults" (f)): D 144 and 192 pad to the 256-wide
# instances, 256 is one, 320 pads to 384; the bf16 kernel gives each CTA
# one COL_BLOCK-wide column block of O, the f32 kernel all of it.  Past
# 384 (400, 512, 1024) the chunked instances: D padded to a multiple of
# 128, a CTA one column block of O, S over the chunks of D.  Shapes (B,
# Hq, Hkv, Sq, Skv): GQA 4:1, Sq < Skv and Sq > Skv (rows that see no key
# under causal), neither a multiple of a block.
WIDE_HEAD_DIMS = (144, 192, 256, 320, 400, 512, 1024)
WIDE_HEAD_SHAPES = ((2, 8, 2, 70, 100), (1, 8, 2, 200, 130))
# the padded widths whose instances have rows in the kernels line
WIDE_ROWS = (256, 512)
# the time rows at head dims 256 and 512: attn_train4k's and
# attn_decode32k's layouts (Llama-3.2-1B's heads) with that D; at 512 the
# f32 flash row takes 2 of the 8 batch rows (one launch about 110 ms) and
# the decode row 4 of the 128 (a 2.1 GB cache: SDPA at D 512 runs its
# math path, whose expanded and widened copies of the cache ran out of
# memory at 64, 32 and 16 rows)
WIDE_TRAIN = {256: ((8, 32, 4096, 256), (8, 8, 4096, 256)),
              512: ((8, 32, 4096, 512), (8, 8, 4096, 512))}
WIDE_F32_BATCH = {256: 8, 512: 2}
WIDE_DECODE = {256: ((128, 32, 1, 256), (128, 8, 32768, 256)),
               512: ((4, 32, 1, 512), (4, 8, 32768, 512))}


def wide_head_dim_checks(card, errs):
    """(f) ``flash_attention`` and ``flash_decode`` at WIDE_HEAD_DIMS on
    f32 and bf16, causal and full, at WIDE_HEAD_SHAPES: one launch a call,
    within ATTN_F32_TOL / ATTN_BF16_TOL of the plain versions.  Returns
    the launches by kernels-line row of the bf16 calls padded to a width
    of WIDE_ROWS (the timed instances)."""
    import torch
    from repro_torch.kernels.attention.decode import (flash_decode,
                                                      flash_decode_plain)
    from repro_torch.kernels.attention.flash import (flash_attention,
                                                     flash_attention_plain,
                                                     padded_head_dim)
    gen = torch.Generator().manual_seed(SEED)
    launches = {f"{fn} (D {w})": 0 for w in WIDE_ROWS
                for fn in ("flash_attention", "flash_decode")}
    check(padded_head_dim(400) == 512 and padded_head_dim(1024) == 1024,
          f"padded_head_dim(400) {padded_head_dim(400)}, (1024) "
          f"{padded_head_dim(1024)}")
    mine = {}
    for d in WIDE_HEAD_DIMS:
        width = padded_head_dim(d)
        for dtype, tol in ((torch.float32, ATTN_F32_TOL),
                           (torch.bfloat16, ATTN_BF16_TOL)):
            for b, hq, hkv, sq, skv in WIDE_HEAD_SHAPES:
                q = operand(gen, (b, hq, sq, d), dtype)
                k, v = (operand(gen, (b, hkv, skv, d), dtype)
                        for _ in range(2))
                what = f"D={d} {dtype} q{tuple(q.shape)} kv{tuple(k.shape)}"
                for causal in (True, False):
                    got = launched_once(
                        lambda: flash_attention(q, k, v, causal=causal),
                        "flash_attention", f"flash_attention {what}")
                    compare(f"flash_attention {what} causal={causal}", got,
                            flash_attention_plain(q, k, v, causal=causal),
                            errs=mine, **tol)
                    if width in WIDE_ROWS and dtype == torch.bfloat16:
                        launches[f"flash_attention (D {width})"] += 1
                q1 = q[:, :, :1].contiguous()
                got = launched_once(lambda: flash_decode(q1, k, v),
                                    "flash_decode", f"flash_decode {what}")
                compare(f"flash_decode {what}", got,
                        flash_decode_plain(q1, k, v), errs=mine, **tol)
                if width in WIDE_ROWS and dtype == torch.bfloat16:
                    launches[f"flash_decode (D {width})"] += 1
    for name, err in mine.items():
        d = int(name.split("D=")[1].split()[0])
        if padded_head_dim(d) not in WIDE_ROWS:
            continue
        fn = name.split()[0]
        row = f"{fn} (D {padded_head_dim(d)})"
        errs[row] = max(errs.get(row, 0.0), err)
    log(f"faults (f): flash_attention and flash_decode at head dims "
        f"{WIDE_HEAD_DIMS} (f32 and bf16, causal and full, GQA 4:1, "
        f"shapes {WIDE_HEAD_SHAPES}) one launch a call, within "
        f"ATTN_F32_TOL / ATTN_BF16_TOL (max abs err "
        f"{max(mine.values()):.3e}; past 384 the chunked instances, D "
        f"padded to a multiple of 128); on {card}")
    return launches


def wide_head_dim_times(peaks, errs):
    """Time rows of the instances at head dims 256 and 512 (chunked):
    bf16 and f32 flash at WIDE_TRAIN (causal; f32 at WIDE_F32_BATCH rows),
    bf16 decode at WIDE_DECODE, each beside its plain version run a slice
    at a time and SDPA (``enable_gqa``) at the same D.  ``bound_ms``
    counts the function's operations (4 D a visible pair);
    ``work_bound_ms`` the kernel's own where it computes S once a column
    block: bf16 with P.V in two bf16 terms, (2 D + 4 COL_BLOCK) D /
    COL_BLOCK a pair; the chunked f32 instance (2 D + 2 COL_BLOCK) D /
    COL_BLOCK (the 256-wide f32 kernel computes S once: its own work is
    the function's)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention.decode import (flash_decode,
                                                      flash_decode_plain)
    from repro_torch.kernels.attention.flash import (COL_BLOCK, HEAD_DIMS,
                                                     flash_attention,
                                                     flash_attention_plain)
    # the operands are drawn on the card: a decode cache alone is 8.6e9
    # values
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}

    def draw(shape, dtype, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=dtype) * scale

    def sdpa_ms(q, k, v, causal):
        def call():
            F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                           enable_gqa=True)
        try:
            return time_ms(call), None
        except SmokeFailure:
            # past head dim 256 SDPA has no fused backend, and its many
            # launches a call outrun time_ms's queue: synchronized calls
            return time_sync_ms(call), (
                "F.scaled_dot_product_attention(enable_gqa=True), timed "
                "call by call (time_sync_ms): its launches outran the "
                "queue ahead of the sleep kernel")
        except RuntimeError as e:
            torch.cuda.empty_cache()
            return None, (f"SDPA raised {type(e).__name__}: "
                          f"{str(e).splitlines()[0][:200]}")

    def plain_ms(plain, q, k, v, per_head, **kw):
        def run():
            for _, qc, kc, vc in attention_chunks(q, k, v, per_head):
                plain(qc, kc, vc, **kw)
        return time_sync_ms(run)

    for width in WIDE_ROWS:
        qs, ks = WIDE_TRAIN[width]
        fb = WIDE_F32_BATCH[width]
        for name, dtype, rate, shapes in (
                (f"flash_attention (D {width})", torch.bfloat16,
                 "bf16_tensor_flops", (qs, ks)),
                (f"flash_attention (f32, D {width})", torch.float32,
                 "fp32_flops", ((fb,) + qs[1:], (fb,) + ks[1:]))):
            q = draw(shapes[0], dtype, 0.5)
            k, v = (draw(shapes[1], dtype, 0.5) for _ in range(2))
            y = flash_attention(q, k, v, causal=True)
            compare_attention(name, y, flash_attention_plain, q, k, v, True,
                              ATTN_BF16_TOL if dtype == torch.bfloat16
                              else ATTN_F32_TOL, errs, causal=True)
            bsz, hq, sq, d = q.shape
            pairs = bsz * hq * visible_pairs(sq, k.shape[2], True)
            b_ms, by = bound_ms(peaks, nbytes(q, k, v, y), 4 * d * pairs,
                                rate)
            chunked = d > HEAD_DIMS[-1]
            blocks = (d // COL_BLOCK if dtype == torch.bfloat16 or chunked
                      else 1)
            lib_ms, note = sdpa_ms(q, k, v, True)
            rows[name] = dict(
                ms=time_ms(lambda: flash_attention(q, k, v, causal=True)),
                plain_ms=plain_ms(flash_attention_plain, q, k, v, True,
                                  causal=True),
                library_ms=lib_ms, bound_ms=b_ms, bound_by=by,
                exp_bound_ms=bound_ms(peaks, 0, pairs * blocks,
                                      "mufu_per_s")[0],
                shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} {dtype} causal",
                library=note or "F.scaled_dot_product_attention(enable_gqa="
                                "True)")
            if blocks > 1:
                pv = 4 if dtype == torch.bfloat16 else 2
                rows[name]["work_bound_ms"] = bound_ms(
                    peaks, 0, (2 * d + pv * COL_BLOCK) * blocks * pairs,
                    rate)[0]
            del q, k, v, y
            torch.cuda.empty_cache()
        qs, ks = WIDE_DECODE[width]
        name = f"flash_decode (D {width})"
        q = draw(qs, torch.bfloat16)
        k, v = (draw(ks, torch.bfloat16) for _ in range(2))
        y = flash_decode(q, k, v)
        compare_attention(name, y, flash_decode_plain, q, k, v, False,
                          ATTN_BF16_TOL, errs)
        b_ms, by = bound_ms(peaks, nbytes(q, k, v, y),
                            4 * qs[3] * qs[0] * qs[1] * ks[2], "fp32_flops")
        lib_ms, note = sdpa_ms(q, k, v, False)
        rows[name] = dict(
            ms=time_ms(lambda: flash_decode(q, k, v)),
            plain_ms=plain_ms(flash_decode_plain, q, k, v, False),
            library_ms=lib_ms, bound_ms=b_ms, bound_by=by,
            shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16",
            library=note or "F.scaled_dot_product_attention(enable_gqa="
                            "True)")
        del q, k, v, y
        torch.cuda.empty_cache()
    return rows


def slo_phase(card):
    """The "slo" phase: (a)-(c) above."""
    t0 = time.perf_counter()
    slo_parity_checks(card)
    slo_premise(card)
    head_dim_checks(card)
    log(f"slo phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# "faults": fault injection, guards, checkpoints and recovery on the card
# ---------------------------------------------------------------------------
# (b) the single-device chaos schedule on ladder_fused's deployment: the
# four single-device kinds, step- and p-triggered, drawn from FAULT_SEED;
# heavy rejects a non-finite batch, light re-plans it with the ladder
# off.  Backoff delays are short: the round loop passes no deadline.
FAULT_SEED = 11
CHAOS_SCHEDULE = (("kernel_exception", dict(step=1)),
                  ("nan_output", dict(step=2)),
                  ("nan_output", dict(p=0.15, once=False, tenant="light")),
                  ("kernel_exception", dict(p=0.1, once=False)),
                  ("latency_spike", dict(p=0.25, once=False, param=3.0)),
                  ("budget_shrink", dict(step=4, param=0.9)))
CHAOS_POLICIES = {"heavy": dict(max_retries=2, backoff_base_s=1e-4),
                  "light": dict(on_nonfinite="retry_f32", max_retries=2,
                                backoff_base_s=1e-4)}
GUARD_EVENTS = ("fault.injected", "retry.attempt", "guard.rejected")
GUARD_COLUMNS = ("guard_retries", "guard_shed", "guard_rejected")
RECOVERY_REPS = 5          # timed snapshots and recoveries, median
HEARTBEAT_S = 1.0          # (e) the watchdog's timeout


def chaos_run(device, trace, guarded):
    """ladder_fused's deployment on ``device`` under CHAOS_SCHEDULE
    (guards CHAOS_POLICIES, or none): each wave submitted, then stepped
    until drained; a step that raises loses its batch.  Returns the
    completions by rid, the batches lost, the server and the guard
    events."""
    import torch
    from repro_torch.obs import EVENTS
    from repro_torch.runtime.faults import INJECTOR, FaultSpec, InjectedFault
    from repro_torch.runtime.guards import GuardPolicy
    srv = ladder_server("ladder_fused", device)
    if guarded:
        for name, kw in CHAOS_POLICIES.items():
            srv.set_guard(name, GuardPolicy(**kw))
    EVENTS.clear()
    done, lost = [], 0
    with INJECTOR.armed([FaultSpec(k, **kw) for k, kw in CHAOS_SCHEDULE],
                        seed=FAULT_SEED):
        for wave in trace:
            for tenant, x in wave:
                srv.submit(tenant, x)
            while srv.pending():
                try:
                    done += srv.step()
                except InjectedFault:
                    lost += 1
    if srv.device.type == "cuda":
        torch.cuda.synchronize()
    events = [(e["kind"], {k: v for k, v in e.items()
                           if k not in ("kind", "t", "ts", "seq")})
              for e in EVENTS.recent() if e["kind"] in GUARD_EVENTS]
    return sorted(done, key=lambda c: c.rid), lost, srv, events


def faults_transparency(card, trace):
    """(a) ladder_fused's deployment on the card through the trace with
    the injector disarmed, armed on a schedule that never fires, and
    disarmed again: results, completions, grants and telemetry bitwise
    equal."""
    import torch
    from repro_torch.runtime.faults import FAULT_KINDS, INJECTOR, FaultSpec
    check(not INJECTOR.enabled, "the injector was left armed")
    runs = []
    for armed in (False, True, False):
        srv = ladder_server("ladder_fused", None)
        if armed:
            with INJECTOR.armed([FaultSpec(k, step=10**9)
                                 for k in FAULT_KINDS], seed=FAULT_SEED):
                done, grants = run_trace(srv, trace)
                polls = INJECTOR.counters()
        else:
            done, grants = run_trace(srv, trace)
        runs.append((done, grants, srv.telemetry()))
    check(polls.get("execute", 0) > 0 and polls.get("output", 0) > 0
          and polls.get("lane", 0) > 0, f"seams not polled: {polls}")
    base = runs[0]
    for done, grants, tel in runs[1:]:
        check([(c.rid, c.tenant, c.ok, c.finished, c.batch_size)
               for c in done] == [(c.rid, c.tenant, c.ok, c.finished,
                                   c.batch_size) for c in base[0]],
              "faults (a): completions differ between the arms")
        check(all(torch.equal(a.result, b.result)
                  for a, b in zip(done, base[0])),
              "faults (a): a result differs between the arms")
        check(grants == base[1] and tel == base[2],
              "faults (a): grants or telemetry differ between the arms")
    log(f"faults (a): ladder_fused, {len(base[0])} requests disarmed, "
        f"armed never firing (polls {polls}) and disarmed again: results, "
        f"completions, grants and telemetry bitwise equal; on {card}")


def faults_chaos(card, trace):
    """(b) CHAOS_SCHEDULE guarded on the card == on the CPU (completions,
    guard columns, events; f32 within rtol=1e-4, atol=1e-5, the light
    tenant under the code-flip rule); availability of the guarded and
    the bare arm; a NaN under retry_f32 re-plans with the ladder off and
    launches the f32 plan's kernels; device loss on one device."""
    import torch
    from repro_torch.core.plan import replan
    from repro_torch.kernels import cuda
    from repro_torch.obs import EVENTS
    from repro_torch.runtime.faults import INJECTOR, DeviceLost, FaultSpec
    from repro_torch.runtime.guards import GuardPolicy, execute_guarded
    n = sum(len(w) for w in trace)
    done, lost, srv, events = chaos_run(None, trace, True)
    check(srv.device.type == "cuda", "server did not default to cuda")
    cpu_done, _, cpu, cpu_events = chaos_run("cpu", trace, True)
    check(len(done) == n and lost == 0,
          f"faults (b): guarded arm {len(done)} completions of {n}, "
          f"{lost} batches lost")
    check([(c.rid, c.tenant, c.ok) for c in done]
          == [(c.rid, c.tenant, c.ok) for c in cpu_done],
          "faults (b): completions differ from the CPU server")
    check(events == cpu_events, "faults (b): guard events differ from the "
                                "CPU server's")
    kinds = {e["fault"] for k, e in events if k == "fault.injected"}
    check(kinds == {"kernel_exception", "nan_output", "latency_spike",
                    "budget_shrink"}, f"faults (b): kinds fired {kinds}")
    tel, cpu_tel = srv.telemetry(), cpu.telemetry()
    for t in ("heavy", "light"):
        for col in GUARD_COLUMNS:
            check(tel[t][col] == cpu_tel[t][col],
                  f"faults (b): {t} {col} {tel[t][col]} vs CPU "
                  f"{cpu_tel[t][col]}")
    light = torch.stack([torch.as_tensor(x) for wave in trace
                         for t, x in wave if t == "light"]).cuda()
    steps = {"heavy": 0.0,
             "light": code_flip_step(srv.tenants["light"].params, light)}
    for a, b in zip(done, cpu_done):
        if a.ok:
            check(bool(torch.isfinite(a.result).all()),
                  f"faults (b): rid {a.rid} served non-finite")
            code_flip(f"faults (b) rid {a.rid}", a.result.cpu(), b.result,
                      steps[a.tenant])
    ok = sum(1 for c in done if c.ok and bool(torch.isfinite(c.result).all()))
    bare, bare_lost, _, _ = chaos_run(None, trace, False)
    bare_ok = sum(1 for c in bare if bool(torch.isfinite(c.result).all()))
    check(bare_ok < ok, f"faults (b): the bare arm served {bare_ok} finite "
                        f"results, the guarded {ok}")
    cols = {t: {c: tel[t][c] for c in GUARD_COLUMNS} for t in tel}
    log(f"faults (b): {len(events)} guard events, {sorted(kinds)} fired; "
        f"card == CPU (completions, ok flags, {GUARD_COLUMNS}, events; "
        f"f32 within rtol=1e-4, atol=1e-5, light under the code-flip rule); "
        f"availability guarded {ok / n!r} ({ok}/{n}, {cols}), bare "
        f"{bare_ok / n!r} ({bare_ok}/{n}, {bare_lost} batches lost, "
        f"{len(bare) - bare_ok} served non-finite); on {card}")

    # a NaN under retry_f32 where the f32 plan fits: the light tenant
    # alone on ladder_fused's budget (granted the whole device).  The
    # retry plans with the ladder off and launches that plan's kernels.
    # (Squeezed beside heavy, as in the chaos run, the f32 plan does not
    # fit light's slice: the retry raises PartitionError and the batch is
    # rejected once the retries run out, as in the reference.)
    from repro_torch.core.resources import ResourceBudget
    from repro_torch.models.frontends import init_cnn_frontend
    from repro_torch.runtime import AdaptiveServer
    budget, fuse, _, _ = LADDER["ladder_fused"]
    srv = AdaptiveServer(ResourceBudget(**budget), max_batch=MAX_BATCH,
                         fuse=fuse)
    srv.register("light", init_cnn_frontend(SEED + 1, device=srv.device),
                 IMAGE, activation="tanh", ladder=(16, 8))
    srv.set_guard("light", GuardPolicy(**CHAOS_POLICIES["light"]))
    xs = [x for wave in trace for t, x in wave if t == "light"][:2]
    EVENTS.clear()
    with INJECTOR.armed([FaultSpec("nan_output", p=1.0, tenant="light")],
                        seed=FAULT_SEED):
        for x in xs:
            srv.submit("light", x)
        cuda.reset_launches()
        comps = srv.step()
        torch.cuda.synchronize()
        launches = cuda.launch_counts()
    t = srv.tenants["light"]
    want, plans = {}, {}
    for lad in (t.ladder, ()):
        specs = srv._specs(t.params, (len(xs),) + IMAGE, "float32",
                           t.pool_window, t.activation, lad)
        plan = replan(specs, srv.budget.scaled(t.granted), fuse=srv.fuse)
        plans[lad] = plan_str(plan)
        for site in plan.sites:
            k = CNN_MEMBER_KERNEL[site.ip.name]
            want[k] = want.get(k, 0) + 1
    retries = EVENTS.recent(kind="retry.attempt")
    check(len(comps) == len(xs) and all(c.ok for c in comps)
          and all(bool(torch.isfinite(c.result).all()) for c in comps),
          "faults (b): the retry_f32 batch was not served finite")
    check([e["cause"] for e in retries] == ["nonfinite"],
          f"faults (b): retries {retries}")
    check(all(x.endswith("@32") for x in plans[()].split())
          and any(k.startswith("fused_cnn") for k in launches),
          f"faults (b): the retry planned {plans[()]}, launched {launches}")
    check(launches == want, f"faults (b): retry_f32 launched {launches}, "
                            f"the attempt's and the retry's plans name "
                            f"{want}")
    log(f"faults (b): NaN under retry_f32 (light alone, granted "
        f"{t.granted!r}): attempt {plans[t.ladder]}, retry with the ladder "
        f"off {plans[()]}; launches {launches} == both plans' kernels; "
        f"beside heavy the f32 retry does not fit light's slice (light "
        f"guard_rejected {tel['light']['guard_rejected']}); on {card}")

    # device loss on one device: the schedule's marks the corpse and the
    # batch serves (no mesh slice overlaps it, as in the reference); a
    # DeviceLost reaching the guard is rejected, the degradation raising
    # the arbiter's "mesh-mode only"
    srv = ladder_server("ladder_fused", None)
    srv.set_guard("heavy", GuardPolicy())
    with INJECTOR.armed([FaultSpec("device_loss", step=0, param=0)]):
        srv.submit("heavy", trace[0][0][1])
        comps = srv.step()
        corpse = set(INJECTOR.lost)
    check(len(comps) == 1 and comps[0].ok and corpse == {0},
          f"faults (b): scheduled device_loss: {comps}, lost {corpse}")

    def attempt(retry_f32=False):
        raise DeviceLost("device 0 lost", device=0)

    y, report = execute_guarded(
        attempt, srv.guard_for("heavy"), tenant="heavy",
        on_device_loss=lambda e: srv.on_device_loss(e.device))
    check(y is None and report.outcome == "rejected"
          and "mesh-mode only" in report.reason,
          f"faults (b): DeviceLost on one device gave {report}")
    log(f"faults (b): device_loss on one device: scheduled, lost {corpse} "
        f"and served; raised into the guard, {report.outcome} "
        f"({report.reason}); on {card}")
    return ok / n, bare_ok / n


def faults_propagation(card):
    """(c) A guarded attempt that launches a real wrapper on operands it
    refuses (a CUDA view 4 bytes past a 16-byte boundary), or calls the
    C entry with a dtype code it rejects (cudaErrorInvalidValue, raised
    by kernels/cuda.py as a RuntimeError): execute_guarded re-raises the
    original exception, with no retry, no event and no launch counted."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.kernels.attention.flash import flash_attention
    from repro_torch.obs import EVENTS
    from repro_torch.runtime.guards import GuardPolicy, execute_guarded
    base = torch.zeros(2 * 4 * 64 + 1, device="cuda")
    q = base[1:].view(1, 2, 4, 64)                 # 4 bytes past 16
    k = torch.zeros(1, 2, 4, 64, device="cuda")
    o = torch.empty_like(k)

    def misaligned(retry_f32=False):
        return flash_attention(q, k, k)

    def bad_code(retry_f32=False):
        cuda.launch("flash_attention", "attn_flash", k.device, 99,
                    k.data_ptr(), k.data_ptr(), k.data_ptr(), o.data_ptr(),
                    1, 2, 2, 4, 4, 64, 1, 0.125)

    seen = []
    for fn, err in ((misaligned, ValueError), (bad_code, RuntimeError)):
        EVENTS.clear()
        cuda.reset_launches()
        calls = []

        def attempt(retry_f32=False):
            calls.append(retry_f32)
            return fn(retry_f32)

        try:
            execute_guarded(attempt, GuardPolicy(max_retries=3),
                            tenant="heavy", on_device_loss=lambda e: None)
        except err as e:
            seen.append(f"{type(e).__name__}: {e}")
        else:
            check(False, f"faults (c): {fn.__name__} did not raise {err}")
        torch.cuda.synchronize()
        check(calls == [False] and not cuda.launch_counts()
              and not EVENTS.recent(kind="retry.attempt")
              and not EVENTS.recent(kind="guard.rejected"),
              f"faults (c): {fn.__name__} retried, launched or was "
              f"absorbed")
    log(f"faults (c): a guarded attempt re-raised {seen[0]!r} and "
        f"{seen[1]!r} with no retry, no event and no launch; on {card}")


def ckpt_bytes(path):
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def faults_recovery(card, trace, ckpt_dir):
    """(d) A served, guarded ladder_fused deployment under an
    SLOScheduler: snapshot, the same wave served pre-crash, simulated
    death, ``recover_server(device=None)``: zero cold plans over the
    restore and the first wave, the wave bitwise equal, params on cuda;
    a bf16 tenant's params and first batch bitwise.  Snapshot and
    recovery wall times (median of RECOVERY_REPS), checkpoint bytes and
    plans imported logged.  Returns the recovered scheduler's server
    and the timings."""
    import torch
    from repro_torch.core.plan import (STATS, clear_plan_cache,
                                       plan_cache_stats)
    from repro_torch.core.resources import ResourceBudget
    from repro_torch.models.frontends import init_cnn_frontend
    from repro_torch.runtime import (AdaptiveServer, GuardPolicy,
                                     SLOScheduler, SLOSpec, recover_server,
                                     simulate_worker_death, snapshot_server)
    from repro_torch.runtime.recovery import cold_replans_since
    budget, fuse, _, _ = LADDER["ladder_fused"]
    clear_plan_cache()
    srv = AdaptiveServer(ResourceBudget(**budget), policy="demand",
                         max_batch=MAX_BATCH, fuse=fuse)
    sched = SLOScheduler(srv)
    sched.register("heavy", init_cnn_frontend(SEED, device=srv.device),
                   IMAGE, slo=SLOSpec(deadline_s=60.0))
    sched.register("light", init_cnn_frontend(SEED + 1, device=srv.device),
                   IMAGE, activation="tanh", ladder=(16, 8),
                   slo=SLOSpec(deadline_s=60.0))
    for name, kw in CHAOS_POLICIES.items():
        srv.set_guard(name, GuardPolicy(**kw))

    def wave(s, w):
        for tenant, x in w:
            s.submit(tenant, x)
        out = sorted(s.run(), key=lambda c: c.rid)
        torch.cuda.synchronize()
        return out

    wave(sched, trace[0])
    wave(sched, trace[0])           # the demand EWMA at the mix's fixed point
    snap_ms = []
    for rep in range(RECOVERY_REPS):
        t0 = time.perf_counter()
        path = snapshot_server(srv, ckpt_dir, 1 + rep, scheduler=sched)
        snap_ms.append((time.perf_counter() - t0) * 1e3)
    n_bytes = ckpt_bytes(path)
    plans = len(json.loads((Path(path) / "manifest.json").read_text())
                ["extra"]["plan_cache"]["plans"])
    pre = wave(sched, trace[1])
    rec_ms = []
    for rep in range(RECOVERY_REPS):
        simulate_worker_death()
        check(plan_cache_stats()["size"] == 0, "faults (d): cache survived")
        before = STATS.plan_misses
        t0 = time.perf_counter()
        srv2, sched2 = recover_server(ckpt_dir)
        rec_ms.append((time.perf_counter() - t0) * 1e3)
    check(srv2.device.type == "cuda" and sched2 is not None,
          f"faults (d): recovered on {srv2.device}, scheduler {sched2}")
    check(all(p.is_cuda for t in srv2.tenants.values()
              for p in [t.params["proj"]] + [b["w"] for b in
                                             t.params["blocks"]]),
          "faults (d): recovered params not on cuda")
    check(srv2.guard_for("light") == srv.guard_for("light"),
          "faults (d): guard policies not restored")
    post = wave(sched2, trace[1])
    cold = cold_replans_since(before)
    check(cold == 0, f"faults (d): {cold} cold plans after recovery")
    check(len(post) == len(pre) and all(
        a.ok and b.ok and a.tenant == b.tenant and torch.equal(a.result,
                                                               b.result)
        for a, b in zip(post, pre)),
        "faults (d): the first post-recovery wave differs from the "
        "pre-crash server's")
    # a bf16 tenant: params and its first batch bitwise across the crash
    clear_plan_cache()
    bsrv = AdaptiveServer(max_batch=MAX_BATCH)
    bsrv.register("bf16", frontend_params("bfloat16", bsrv.device), IMAGE)
    xb = frontend_requests("bfloat16")[:MAX_BATCH]
    bsrv.submit("bf16", torch.stack([torch.as_tensor(x) for x in xb]))
    bsrv.step()
    snapshot_server(bsrv, Path(ckpt_dir) / "bf16", 1)
    bsrv.submit("bf16", torch.stack([torch.as_tensor(x) for x in xb]))
    bpre = bsrv.step()
    simulate_worker_death()
    before = STATS.plan_misses
    bsrv2, _ = recover_server(Path(ckpt_dir) / "bf16")
    p, q = bsrv.tenants["bf16"].params, bsrv2.tenants["bf16"].params
    for u, v in [(p["proj"], q["proj"])] + [
            (a["w"], b["w"]) for a, b in zip(p["blocks"], q["blocks"])]:
        check(u.dtype == v.dtype == torch.bfloat16 and v.is_cuda
              and torch.equal(u.view(torch.int16), v.view(torch.int16)),
              "faults (d): bf16 params did not round-trip bitwise")
    bsrv2.submit("bf16", torch.stack([torch.as_tensor(x) for x in xb]))
    bpost = bsrv2.step()
    torch.cuda.synchronize()
    check(cold_replans_since(before) == 0,
          "faults (d): the bf16 tenant planned cold after recovery")
    check(all(torch.equal(a.result, b.result) for a, b in zip(bpre, bpost)),
          "faults (d): the bf16 tenant's first batch differs")
    med_snap, med_rec = statistics.median(snap_ms), statistics.median(rec_ms)
    log(f"faults (d): snapshot_server {med_snap!r} ms (median of "
        f"{RECOVERY_REPS}: {', '.join(f'{t:.3f}' for t in snap_ms)}), "
        f"recover_server {med_rec!r} ms ({', '.join(f'{t:.3f}' for t in rec_ms)}); "
        f"checkpoint {n_bytes} bytes, {plans} plans imported; 0 cold plans "
        f"over the restore and the first wave ({len(post)} requests, "
        f"bitwise the pre-crash server's); bf16 tenant bitwise; on {card}")
    return sched2, med_snap, med_rec, n_bytes, plans


def faults_heartbeat(card, sched, trace, ckpt_dir):
    """(e) A RecoveryManager with a HEARTBEAT_S watchdog over the
    recovered scheduler on the card: serving beats it; silence fires it
    (fire-once: the callback stops the watchdog); ``recover()`` re-arms
    it, serving beats again, and a second silence fires again."""
    import torch
    from repro_torch.runtime import RecoveryManager
    died = []
    holder = {}

    def on_death():
        died.append(time.monotonic())
        holder["mgr"].watchdog.stop()

    mgr = RecoveryManager(sched.server, ckpt_dir, scheduler=sched,
                          heartbeat_timeout_s=HEARTBEAT_S, on_death=on_death)
    holder["mgr"] = mgr
    sched.recovery = mgr

    def serve_then_wait(s, deaths):
        for tenant, x in trace[2]:
            s.submit(tenant, x)
        s.run()
        torch.cuda.synchronize()
        quiet = time.monotonic()
        while len(died) < deaths and time.monotonic() < quiet + 10 * HEARTBEAT_S:
            time.sleep(0.01)
        return quiet

    try:
        mgr.snapshot()
        quiet1 = serve_then_wait(sched, 1)
        check(len(died) == 1, f"faults (e): first silence fired {len(died)}")
        mgr.recover()
        check(mgr.watchdog._thread.is_alive() and not mgr.watchdog.fired
              and mgr.scheduler.recovery is mgr,
              "faults (e): recover() did not re-arm the watchdog")
        quiet2 = serve_then_wait(mgr.scheduler, 2)
        check(len(died) == 2, f"faults (e): second silence fired "
                              f"{len(died)} times in all")
    finally:
        mgr.stop()
    log(f"faults (e): RecoveryManager(heartbeat_timeout_s={HEARTBEAT_S}) "
        f"fired {died[0] - quiet1:.3f} s into the first silence and, after "
        f"recover(), {died[1] - quiet2:.3f} s into the second; on {card}")


def faults_phase(card, trace, errs):
    """The "faults" phase: (a)-(f) above.  Returns the launches of the
    head-dim-256 rows (f) and the phase's numbers."""
    import tempfile
    from repro_torch.runtime.faults import INJECTOR
    t0 = time.perf_counter()
    try:
        faults_transparency(card, trace)
        avail = faults_chaos(card, trace)
        faults_propagation(card)
        with tempfile.TemporaryDirectory(prefix="faults_ckpt") as ckpt:
            sched, snap_ms, rec_ms, n_bytes, plans = faults_recovery(
                card, trace, ckpt)
            faults_heartbeat(card, sched, trace, Path(ckpt) / "heartbeat")
        launches = wide_head_dim_checks(card, errs)
    finally:
        INJECTOR.disarm()
    log(f"faults phase: {time.perf_counter() - t0:.1f} s")
    return launches, dict(availability=avail, snapshot_ms=snap_ms,
                          recover_ms=rec_ms, ckpt_bytes=n_bytes,
                          plans_imported=plans)


# ---------------------------------------------------------------------------
# "calibration": the measurement loop (core/calibrate_cost.py) on the card
# ---------------------------------------------------------------------------
def plan_str(plan):
    """A plan's sites as member@bits, or "x" for an infeasible arm."""
    if plan is None:
        return "x"
    return " ".join(f"{s.ip.name.split('.')[-1]}@{s.precision_bits}"
                    for s in plan.sites)


def calibration_sampling(card):
    """(a) Plan both arms of every CAL_NETWORKS x CAL_BATCHES x
    CAL_BUDGETS cell with the analytical model, run every distinct
    planned site standalone on the card and fit.  Returns the networks,
    the arms by (network, batch, budget) and the fitted table."""
    import torch
    from repro_torch.core.calibrate_cost import (CalibrationTable,
                                                 collect_plan_samples)
    from repro_torch.core.plan import clear_plan_cache, plan_network
    from repro_torch.core.resources import ResourceBudget
    from repro_torch.models.frontends import (cnn_frontend_site_specs,
                                              init_cnn_frontend)
    clear_plan_cache()
    nets = {name: (init_cnn_frontend(seed, device="cuda"), act, ladder)
            for name, (seed, act, ladder) in CAL_NETWORKS.items()}

    def specs_of(net, batch):
        p, act, ladder = nets[net]
        return cnn_frontend_site_specs(p, (batch,) + IMAGE, torch.float32,
                                       activation=act, ladder=ladder)

    arms = {}
    for net in nets:
        for batch in CAL_BATCHES:
            for bname, kw in CAL_BUDGETS.items():
                pair = []
                for fuse in (False, True):
                    try:
                        pair.append(plan_network(specs_of(net, batch),
                                                 ResourceBudget(**kw),
                                                 fuse=fuse))
                    except ValueError:
                        pair.append(None)
                arms[(net, batch, bname)] = tuple(pair)
                if batch == CAL_BATCHES[-1]:
                    log(f"calibration plan {net} batch {batch} {bname}: "
                        f"unfused {plan_str(pair[0])} | fused "
                        f"{plan_str(pair[1])}")
    t0 = time.perf_counter()
    table = collect_plan_samples([p for pair in arms.values() for p in pair],
                                 device="cuda", repeat=CAL_REPEAT).fit()
    sample_s = time.perf_counter() - t0
    text = table.to_json()
    check(CalibrationTable.from_json(text).to_json() == text,
          "calibration table JSON round trip is not bit-exact")
    keys = sorted({s.member for s in table.samples})
    for m in keys:
        check(m in table.fits
              and table.fits[m].n_samples >= table.min_samples,
              f"calibration: member {m} has no dedicated fit "
              f"({table.sample_count(m)} samples)")
    for m, f in list(table.fits.items()) + [("global", table.global_fit)]:
        check(min(f.us_per_compute_cycle, f.us_per_hbm_byte,
                  f.us_per_comm_cycle, f.overhead_us) >= 0.0,
              f"calibration: fit {m} has a negative coefficient {f}")
    log(f"calibration (a): {table.sample_count()} samples of "
        f"{len(keys)} member keys (timeit_us, 1 warmup + median of "
        f"{CAL_REPEAT} blocking calls each) in {sample_s:.1f} s; "
        f"{len(table.fits)} dedicated fits; fingerprint "
        f"{table.fingerprint()}; JSON round trip bit-exact; every "
        f"coefficient >= 0; on {card}")
    for m, f in sorted(table.fits.items()) + [("(global)",
                                                table.global_fit)]:
        log(f"calibration fit {m}: us_per_compute_cycle "
            f"{f.us_per_compute_cycle!r}, us_per_hbm_byte "
            f"{f.us_per_hbm_byte!r}, overhead_us {f.overhead_us!r}, "
            f"n_samples {f.n_samples} on {card}")
    return nets, specs_of, arms, table


def paired_windows(fns, windows, calls):
    """Each of ``fns`` (name -> a call whose result lies on the card)
    timed in ``windows`` windows of ``calls`` blocking calls apiece, the
    arms' calls interleaved one by one (the first arm of a round
    alternating), after one warmup call each: the arms' medians in us,
    window by window.  The garbage collector is off inside a window."""
    import torch
    names = list(fns)
    for f in fns.values():
        f()
    torch.cuda.synchronize()
    out = {n: [] for n in names}
    for _ in range(windows):
        times = {n: [] for n in names}
        gc.collect()
        gc.disable()
        try:
            for i in range(calls):
                for n in (names if i % 2 == 0 else names[::-1]):
                    t0 = time.perf_counter()
                    fns[n]()
                    torch.cuda.synchronize()
                    times[n].append(time.perf_counter() - t0)
        finally:
            gc.enable()
        for n in names:
            out[n].append(statistics.median(times[n]) * 1e6)
    return out


def calibration_premise(card, nets, specs_of, arms, table):
    """(b) The reference's premise (benchmarks/run.py::table_calibration)
    at full width: both arms of every (network, budget) pair at the
    largest batch timed end to end in CAL_WINDOWS windows of paired calls
    (``paired_windows``); the calibrated model must prefer what the
    stopwatch prefers wherever the stopwatch decides (one arm's median is
    below the other's in every window).  (c) logs the sites whose member
    or rung the table moved."""
    import numpy as np
    import torch
    from repro_torch.core.plan import plan_network
    from repro_torch.core.resources import ResourceBudget
    from repro_torch.models.frontends import apply_cnn_frontend
    batch = CAL_BATCHES[-1]
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.normal(size=(batch,) + IMAGE)
                         .astype(np.float32)).cuda()
    pairs = decided = 0
    for net, (p, act, ladder) in nets.items():
        for bname, kw in CAL_BUDGETS.items():
            unf, fus = arms[(net, batch, bname)]
            if unf is None or fus is None:
                log(f"calibration (b) {net} {bname}: unfused "
                    f"{'x' if unf is None else 'ok'}, fused "
                    f"{'x' if fus is None else 'ok'}: not compared")
                continue
            pairs += 1
            wins = paired_windows(
                {arm: (lambda plan=plan: apply_cnn_frontend(
                    p, x, network=plan, activation=act, ladder=ladder))
                 for arm, plan in (("unfused", unf), ("fused", fus))},
                CAL_WINDOWS, CAL_WINDOW_CALLS)
            cal_unf, cal_fus = (unf.calibrated_cycles(table),
                                fus.calibrated_cycles(table))
            cal_plan = plan_network(specs_of(net, batch),
                                    ResourceBudget(**kw), fuse=True,
                                    calibration=table)
            fused_sites = sum(s.spec.family == "cnn_fused"
                              for s in cal_plan.sites)
            faster = [f < u for f, u in zip(wins["fused"], wins["unfused"])]
            slower = [f > u for f, u in zip(wins["fused"], wins["unfused"])]
            measured = True if all(faster) else False if all(slower) else None
            calibrated = cal_fus < cal_unf
            modeled = fus.total_cycles < unf.total_cycles
            match = None if measured is None else calibrated == measured
            if measured is not None:
                decided += 1
                check(match,
                      f"calibration {net} {bname}: the calibrated model "
                      f"prefers {'fused' if calibrated else 'unfused'}, "
                      f"the stopwatch the other ({wins})")
                check(measured or fused_sites == 0,
                      f"calibration {net} {bname}: the stopwatch prefers "
                      f"unfused but the calibrated plan keeps "
                      f"{fused_sites} fused sites")
            med = {a: statistics.median(w) for a, w in wins.items()}
            pref = {None: "tie", True: "1", False: "0"}
            log(f"calibration (b) {net} {bname} batch {batch}: us_unfused "
                f"{med['unfused']:.1f} ({min(wins['unfused']):.1f}-"
                f"{max(wins['unfused']):.1f}), us_fused "
                f"{med['fused']:.1f} ({min(wins['fused']):.1f}-"
                f"{max(wins['fused']):.1f}), cal_unfused {cal_unf:.4e}, "
                f"cal_fused {cal_fus:.4e} cycles; modeled_prefers_fused "
                f"{int(modeled)}, calibrated_prefers_fused "
                f"{int(calibrated)}, measured_prefers_fused "
                f"{pref[measured]}, plans_fused_sites {fused_sites}, "
                f"match {pref[match]} on {card}")
    check(decided >= CAL_MIN_DECIDED,
          f"calibration: the stopwatch decided {decided} of {pairs} pairs, "
          f"fewer than {CAL_MIN_DECIDED}")
    log(f"calibration (b): {pairs} pairs, {decided} decided, the "
        f"calibrated preference equal to the measured one on all of them")

    for net in nets:
        for bname, kw in CAL_BUDGETS.items():
            for fuse, ana in zip((False, True), arms[(net, batch, bname)]):
                try:
                    cal = plan_network(specs_of(net, batch),
                                       ResourceBudget(**kw), fuse=fuse,
                                       calibration=table)
                except ValueError:
                    cal = None
                check((cal is None) == (ana is None),
                      f"calibration {net} {bname}: the table changed "
                      f"feasibility")
                if ana is None:
                    continue
                a = {s.spec.name: f"{s.ip.name}@{s.precision_bits}"
                     for s in ana.sites}
                c = {s.spec.name: f"{s.ip.name}@{s.precision_bits}"
                     for s in cal.sites}
                moved = [f"{n}: {a.get(n, '-')} -> {c.get(n, '-')}"
                         for n in sorted(set(a) | set(c))
                         if a.get(n) != c.get(n)]
                log(f"calibration (c) {net} {bname} "
                    f"{'fused' if fuse else 'unfused'}: "
                    f"{'; '.join(moved) if moved else 'no choice moves'}")


def calibrated_ladder_checks(table, trace):
    """(d) The ladder_fused deployment served by
    ``AdaptiveServer(calibration=table)`` on the card and on the CPU:
    the plans of every batch equal as JSON, accounting and grants
    equal, f32 results within rtol=1e-4, atol=1e-5, lowered ones under
    the code-flip rule, telemetry keyed on the table."""
    import torch
    from repro_torch.core.calibrate_cost import member_key
    runs = {}
    for device in ("cuda", "cpu"):
        srv = ladder_server("ladder_fused", device, table)
        plans = []
        attempt = srv._attempt

        def recorded(tenant, xb, attempt=attempt, plans=plans, **kw):
            y, plan, err = attempt(tenant, xb, **kw)
            plans.append((tenant.name, tuple(xb.shape), plan))
            return y, plan, err

        srv._attempt = recorded
        done, grants = run_trace(srv, trace)
        runs[device] = (srv, done, grants, plans)
    (srv, done, grants, plans), (cpu, cpu_done, cpu_grants, cpu_plans) = \
        runs["cuda"], runs["cpu"]
    check([(t, b, p.to_json()) for t, b, p in plans]
          == [(t, b, p.to_json()) for t, b, p in cpu_plans],
          "calibrated ladder_fused: the card's and the CPU's plans differ")
    check([(c.rid, c.tenant, c.batch_size, c.finished) for c in done]
          == [(c.rid, c.tenant, c.batch_size, c.finished)
              for c in cpu_done] and grants == cpu_grants,
          "calibrated ladder_fused: accounting or grants differ from the "
          "CPU server")
    for s in (srv, cpu):
        for t, tel in s.telemetry().items():
            check(tel["calibration_key"] == table.key(),
                  f"calibrated ladder_fused {t}: telemetry key "
                  f"{tel['calibration_key']} != {table.key()}")
    light = torch.stack([torch.as_tensor(x) for wave in trace
                         for t, x in wave if t == "light"]).cuda()
    step = code_flip_step(srv.tenants["light"].params, light)
    flips = 0
    for a, b in zip(done, cpu_done):
        check(tuple(a.result.shape) == LADDER_OUT
              and bool(torch.isfinite(a.result).all()),
              f"calibrated ladder_fused rid {a.rid}: bad result")
        if a.tenant == "heavy":
            torch.testing.assert_close(a.result.cpu(), b.result, rtol=1e-4,
                                       atol=1e-5)
        else:
            flips += code_flip(f"calibrated ladder_fused rid {a.rid}",
                               a.result.cpu(), b.result, step)
    variants = sorted({member_key(s.ip.name, s.precision_bits,
                                  s.spec.native_bits)
                       for _, _, p in plans for s in p.sites})
    by_global = [v for v in variants if v not in table.fits]
    light_plans = sorted({(b[0], plan_str(p)) for t, b, p in plans
                          if t == "light"})
    log(f"calibration (d): ladder_fused with calibration=table served "
        f"{len(done)} requests on the card and the CPU: {len(plans)} "
        f"batch plans equal as JSON, accounting and grants {grants[-1]} "
        f"equal, heavy within rtol=1e-4, atol=1e-5, light under the "
        f"code-flip rule ({flips} elements out), calibration_key "
        f"{table.key()}; light plans by batch {light_plans}; variants "
        f"priced by the global fit: {by_global or 'none'}")


def calibration_drift(card, arms, table):
    """(e) A DriftMonitor on the table, fed fresh times of the sites of
    the largest batch's plans: its mean relative error is logged; on a
    table mis-scaled by CAL_MISSCALE it flags exactly once, and
    ``recalibrate()`` moves the fingerprint and re-arms it."""
    from repro_torch.core.calibrate_cost import (measure_planned_site,
                                                 member_key)
    from repro_torch.obs.drift import DriftMonitor, mis_scaled_table
    seen, obs = set(), []
    for (_, batch, _), pair in arms.items():
        for plan in pair:
            if batch != CAL_BATCHES[-1] or plan is None:
                continue
            for site in plan.sites:
                key = (site.ip.name, site.precision_bits, site.spec)
                if key in seen:
                    continue
                seen.add(key)
                obs.append((member_key(site.ip.name, site.precision_bits,
                                       site.spec.native_bits),
                            site.footprint,
                            measure_planned_site(site, device="cuda",
                                                 repeat=CAL_REPEAT)))
    honest = DriftMonitor(table)
    for m, fp, us in obs:
        honest.observe(m, fp, us)
    errs = sorted(((abs(table.predict_us(m, fp.compute_cycles,
                                         fp.hbm_bytes) - us) / us), m)
                  for m, fp, us in obs)
    log(f"calibration (e): drift monitor on the fitted table over "
        f"{len(obs)} fresh site times: mean relative error "
        f"{honest.mean_rel_error:.4f} (window {honest.snapshot()['window']}"
        f", drifted {honest.drifted}); worst {errs[-1][1]} "
        f"{errs[-1][0]:.4f}, median {errs[len(errs) // 2][0]:.4f} on {card}")
    bad = mis_scaled_table(table, CAL_MISSCALE)
    mon = DriftMonitor(bad)
    flags = [r for r in (mon.observe(m, fp, us) for m, fp, us in obs) if r]
    check(len(flags) == 1 and len(mon.reports) == 1 and mon.drifted,
          f"calibration: the table mis-scaled by {CAL_MISSCALE} flagged "
          f"{len(flags)} times")
    before = bad.fingerprint()
    after = mon.recalibrate()
    check(after != before and not mon.drifted,
          "calibration: recalibrate() did not move the fingerprint or "
          "re-arm the monitor")
    log(f"calibration (e): the table mis-scaled by {CAL_MISSCALE} flagged "
        f"once (mean relative error {flags[0].mean_rel_error:.4f}, worst "
        f"{flags[0].worst_member}); recalibrate() moved the fingerprint "
        f"{before} -> {after} and re-armed the monitor")


def calibration_autotune(requests):
    """(f) ``AdaptiveServer(autotune=True)`` on serve_checks' requests:
    bitwise the results of ``autotune=False``."""
    import torch
    srv, tuned = serve("cuda", True, requests, autotune=True)
    _, plain = serve("cuda", True, requests)
    for a, b in zip(tuned, plain):
        check(a.rid == b.rid and torch.equal(a.result, b.result),
              f"rid {a.rid}: autotune=True changed the result")
    overrides = {k: v for tiles in srv._tile_cache.values()
                 for k, v in tiles.items()}
    log(f"calibration (f): autotune=True bitwise equal to autotune=False "
        f"over {len(tuned)} requests; {len(overrides)} sites got overrides "
        f"over {len(srv._tile_cache)} plans: {overrides}")


def calibration_phase(card, trace, requests):
    """The "calibration" phase: (a)-(f) above.  Returns the table."""
    t0 = time.perf_counter()
    nets, specs_of, arms, table = calibration_sampling(card)
    calibration_premise(card, nets, specs_of, arms, table)
    calibrated_ladder_checks(table, trace)
    calibration_drift(card, arms, table)
    calibration_autotune(requests)
    log(f"calibration phase: {time.perf_counter() - t0:.1f} s")
    return table


# ---------------------------------------------------------------------------
# "mesh": mesh sharding (core/shard.py, distributed/, the arbiter's and the
# server's mesh paths) on MESH_DEVICES logical devices of one card
# ---------------------------------------------------------------------------
# The mesh is a tuple of torch.devices, one a rank; on one card the ranks
# are logical devices that share it, asked for by name (never a silent
# stand-in for a missing card).
MESH_DEVICES = 2
# The mesh tenant's per-device budget: the default ResourceBudget, under
# which the planner batch-splits both fused blocks of the default frontend
# at batch 4 over 2 devices (the plan JSON's sha256, MESH_PLAN_SHA, is the
# reference's plan's: tests/test_torch_shard.py holds the two equal).
MESH_BUDGET = {}
MESH_PLAN_SHA = ("a6dbc2c92ed9ce8a44bf31e76fb34d3b"
                 "fa661e8ad0b04a736f56c17b591bf9ad")
MESH_WAVE = 8             # requests a wave: two batches of MAX_BATCH
MESH_WAVES = 2
MESH_TOL = dict(rtol=1e-5, atol=1e-5)
MESH_RATE_WINDOWS = 4     # alternating windows: plain, mesh, mesh, plain


def mesh_devices_by_name():
    import torch
    return (torch.device("cuda", 0),) * MESH_DEVICES


def mesh_execution_checks(card, shapes, errs):
    """(a) ``apply_plan_sharded`` at the full-width blocks on the logical
    devices: a batch split (fused and unfused) bitwise equal to
    ``apply_plan_replicated`` on the card with each sharded site's kernel
    launched once a shard; block 1's conv split by input channel (Cin 16
    -> 8 a device) on both conv members, psum and ring, within MESH_TOL of
    the replicated walk and ring within MESH_TOL of psum; a lowered plan
    refused with the reference's message."""
    import dataclasses
    import torch
    from repro_torch.core.ip import SiteSpec
    from repro_torch.core.library import get_ip
    from repro_torch.core.plan import clear_plan_cache, plan_network
    from repro_torch.core.resources import MeshSpec, ResourceBudget
    from repro_torch.core.shard import force_shard_decisions
    from repro_torch.distributed import (apply_plan_replicated,
                                         apply_plan_sharded)
    from repro_torch.kernels import cuda
    from repro_torch.models.blocks import cnn_block_site_specs
    devices = mesh_devices_by_name()
    d = MESH_DEVICES
    mesh = MeshSpec(devices=d)
    gen = torch.Generator().manual_seed(SEED)
    clear_plan_cache()
    runs = []
    for name, (xs, ws) in shapes.items():
        x = operand(gen, xs, torch.float32)
        w = operand(gen, ws, torch.float32, (ws[0] * ws[1] * ws[2]) ** -0.5)
        specs, _ = cnn_block_site_specs(xs, ws, x_dtype="float32", site=name)
        weights = {f"{name}.conv": w, f"{name}.fused": w}
        for fuse in (True, False):
            plan = plan_network(tuple(specs), ResourceBudget(), fuse=fuse)
            force_shard_decisions(tuple(s.spec for s in plan.sites), mesh,
                                  axis="batch")
            split = dataclasses.replace(plan, mesh=mesh, sites=tuple(
                dataclasses.replace(s, shard_axis="batch", shard_degree=d)
                for s in plan.sites))
            want = apply_plan_replicated(plan, x, weights)
            cuda.reset_launches()
            got = apply_plan_sharded(split, x, weights, devices=devices)
            torch.cuda.synchronize()
            counts = cuda.launch_counts()
            expect = {}
            for s in plan.sites:
                k = CNN_MEMBER_KERNEL[s.ip.name]
                expect[k] = expect.get(k, 0) + d
            check(counts == expect, f"mesh (a) {name} fuse={fuse}: launched "
                                    f"{counts}, expected {expect}")
            check(got.is_cuda and torch.equal(got, want),
                  f"mesh (a) {name} fuse={fuse}: batch split differs from "
                  f"the replicated walk")
            runs.append(f"{name} {'fused' if fuse else 'unfused'} "
                        f"{dict(sorted(counts.items()))}")
    xs, ws = shapes["block1"]
    x = operand(gen, xs, torch.float32)
    w = operand(gen, ws, torch.float32, (ws[0] * ws[1] * ws[2]) ** -0.5)
    spec = SiteSpec.make("b1conv", "conv2d", (xs, ws), "float32",
                         dual=False)
    base = plan_network((spec,), ResourceBudget())
    chan_err = 0.0
    for ip in ("conv2d.ip1_vpu", "conv2d.ip2_mxu"):
        site = dataclasses.replace(base.sites[0], ip=get_ip(ip))
        rep = dataclasses.replace(base, sites=(site,))
        chan = dataclasses.replace(base, mesh=mesh, sites=(
            dataclasses.replace(site, shard_axis="chan", shard_degree=d),))
        want = apply_plan_replicated(rep, x, {"b1conv": w})
        outs = {}
        for ring in (False, True):
            cuda.reset_launches()
            outs[ring] = apply_plan_sharded(chan, x, {"b1conv": w},
                                            use_ring=ring, devices=devices)
            torch.cuda.synchronize()
            counts = cuda.launch_counts()
            check(counts == {CNN_MEMBER_KERNEL[ip]: d},
                  f"mesh (a) chan {ip} ring={ring}: launched {counts}")
            torch.testing.assert_close(outs[ring], want, **MESH_TOL,
                                       msg=lambda m: f"mesh (a) chan {ip}: "
                                                     f"{m}")
            chan_err = max(chan_err, float((outs[ring] - want).abs().max()))
        torch.testing.assert_close(outs[True], outs[False], **MESH_TOL,
                                   msg=lambda m: f"mesh (a) ring vs psum: "
                                                 f"{m}")
    errs["mesh channel split"] = chan_err
    lo = SiteSpec.make("lo", "conv2d", ((2, 8, 8, 4), (3, 3, 4, 8)),
                       "float32", ladder=(16, 8), dual=False)
    lowered = plan_network((lo,), ResourceBudget(vmem_bytes=3 * 1024))
    bits = lowered.sites[0].precision_bits
    try:
        apply_plan_sharded(lowered, x, devices=devices)
    except ValueError as e:
        check(str(e) == f"site 'lo' was lowered to int{bits}; sharded "
                        f"execution is float-only — plan without a ladder "
                        f"or without a mesh", f"mesh (a) refusal: {e}")
    else:
        check(False, "mesh (a): a lowered plan was not refused")
    log(f"mesh (a): {d} logical devices on one card; batch splits bitwise "
        f"the replicated walk, one launch a shard ({'; '.join(runs)}); "
        f"block 1's conv split by input channel ({ws[2]} -> "
        f"{ws[2] // d} a device) on ip1_vpu and ip2_mxu, psum and ring, "
        f"within rtol=1e-5, atol=1e-5 (max abs err {chan_err:.3e}); the "
        f"lowered plan refused; on {card}")


def mesh_server(device, devices, guarded=False):
    from repro_torch.core.plan import clear_plan_cache
    from repro_torch.core.resources import MeshSpec, ResourceBudget
    from repro_torch.models.frontends import init_cnn_frontend
    from repro_torch.runtime import GuardPolicy
    from repro_torch.runtime.server import AdaptiveServer
    clear_plan_cache()
    srv = AdaptiveServer(ResourceBudget(**MESH_BUDGET),
                         mesh=MeshSpec(devices=MESH_DEVICES),
                         max_batch=MAX_BATCH, device=device, devices=devices)
    srv.register("cnn", init_cnn_frontend(SEED, device=srv.device), IMAGE)
    if guarded:
        srv.set_guard("cnn", GuardPolicy(max_retries=2,
                                         backoff_base_s=0.001))
    return srv


def mesh_trace(seed=SEED):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.normal(size=IMAGE).astype(np.float32)
            for _ in range(MESH_WAVE * MESH_WAVES)]


def mesh_wave(srv, requests):
    for x in requests:
        srv.submit("cnn", x)
    return sorted(srv.drain(), key=lambda c: c.rid)


def mesh_serving_checks(card):
    """(b) A mesh-mode AdaptiveServer (MeshSpec(devices=2) on two logical
    devices of the card, by name) serves the default frontend at full
    width through sharded plans: the plan's JSON is the reference's
    (MESH_PLAN_SHA), every batch runs both fused kernels once a shard,
    and the completions equal the CPU port's mesh server's within
    rtol=1e-4, atol=1e-5 with the same accounting."""
    import hashlib
    import torch
    from repro_torch.core.plan import plan_network
    from repro_torch.core.resources import MeshSpec, ResourceBudget
    from repro_torch.kernels import cuda
    from repro_torch.models.frontends import cnn_frontend_site_specs
    trace = mesh_trace()
    srv = mesh_server(None, mesh_devices_by_name())
    check(srv.device.type == "cuda" and srv.devices ==
          mesh_devices_by_name(), f"mesh server on {srv.device}, "
                                  f"devices {srv.devices}")
    specs = tuple(cnn_frontend_site_specs(
        srv.tenants["cnn"].params, (MAX_BATCH,) + IMAGE, torch.float32))
    plan = plan_network(specs, ResourceBudget(**MESH_BUDGET),
                        mesh=MeshSpec(devices=MESH_DEVICES))
    sha = hashlib.sha256(plan.to_json().encode()).hexdigest()
    check(sha == MESH_PLAN_SHA, f"mesh plan JSON sha256 {sha}, the "
                                f"reference's is {MESH_PLAN_SHA}")
    check(all(s.shard_axis == "batch" and s.shard_degree == MESH_DEVICES
              for s in plan.sites), f"mesh plan {plan.describe()}")
    cuda.reset_launches()
    done = []
    for i in range(MESH_WAVES):
        done += mesh_wave(srv, trace[i * MESH_WAVE:(i + 1) * MESH_WAVE])
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    batches = len(trace) // MAX_BATCH
    want = {"fused_cnn_vpu": batches * MESH_DEVICES,
            "fused_cnn_mxu": batches * MESH_DEVICES}
    check(counts == want, f"mesh (b): launched {counts}, expected {want}")
    tel = srv.telemetry()["cnn"]
    check(tel["shard_degree_mix"] == {MESH_DEVICES: 2 * batches},
          f"mesh (b): shard_degree_mix {tel['shard_degree_mix']}")
    cpu = mesh_server("cpu", None)
    cpu_done = []
    for i in range(MESH_WAVES):
        cpu_done += mesh_wave(cpu, trace[i * MESH_WAVE:(i + 1) * MESH_WAVE])
    check(len(done) == len(cpu_done) == len(trace),
          f"mesh (b): {len(done)} / {len(cpu_done)} completions")
    err = 0.0
    for a, b in zip(done, cpu_done):
        check(a.ok and a.result.is_cuda
              and bool(torch.isfinite(a.result).all()),
              f"mesh (b) rid {a.rid}: not ok or off-card")
        torch.testing.assert_close(a.result.cpu(), b.result, rtol=1e-4,
                                   atol=1e-5)
        err = max(err, float((a.result.cpu() - b.result).abs().max()))
        check((a.rid, a.batch_size, a.finished) ==
              (b.rid, b.batch_size, b.finished),
              f"mesh (b) rid {a.rid}: accounting differs from the CPU's")
    check(cpu.telemetry()["cnn"]["shard_degree_mix"] ==
          tel["shard_degree_mix"], "mesh (b): CPU shard mix differs")
    log(f"mesh (b): {MESH_DEVICES} logical devices on one card serve "
        f"{len(trace)} requests at {IMAGE} through the sharded plan "
        f"(sha256 {sha[:16]}.. = the reference's; "
        f"{' + '.join(s.ip.name.split('.')[-1] for s in plan.sites)} "
        f"batch x{MESH_DEVICES}); launches {counts}; within rtol=1e-4, "
        f"atol=1e-5 of the CPU mesh server (max abs err {err:.3e}), "
        f"accounting equal; on {card}")
    return srv, trace


def mesh_device_loss_checks(card):
    """(c) The reference's test_server_survives_device_loss_end_to_end at
    full width: prewarm_spares(losses=1), then a device_loss fault
    mid-wave under a guard: every completion ok, the mesh shrunk to one
    device, 0 cold plans, shard_degree_mix keys [1, 2], precision
    {32}."""
    import torch
    from repro_torch.core.plan import STATS
    from repro_torch.kernels import cuda
    from repro_torch.runtime import INJECTOR, FaultSpec
    trace = mesh_trace(SEED + 1)
    srv = mesh_server(None, mesh_devices_by_name(), guarded=True)
    healthy = mesh_wave(srv, trace[:MESH_WAVE])
    check(all(c.ok for c in healthy), "mesh (c): healthy wave not ok")
    warmed = srv.prewarm_spares(losses=1)
    before = STATS.plan_misses
    cuda.reset_launches()
    with INJECTOR.armed([FaultSpec("device_loss", step=0, param=1)]):
        degraded = mesh_wave(srv, trace[MESH_WAVE:])
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    cold = STATS.plan_misses - before
    tel = srv.telemetry()["cnn"]
    check(len(degraded) == MESH_WAVE and all(c.ok for c in degraded),
          f"mesh (c): {[c.ok for c in degraded]}")
    for c in degraded:
        check(c.result.is_cuda and bool(torch.isfinite(c.result).all()),
              f"mesh (c) rid {c.rid}: non-finite or off-card")
    check(srv.mesh.devices == 1, f"mesh (c): mesh {srv.mesh}")
    check(cold == 0, f"mesh (c): {cold} cold plans after the loss")
    check(tel["degradations"] == 1, f"mesh (c): {tel['degradations']}")
    check(sorted(tel["shard_degree_mix"]) == [1, 2],
          f"mesh (c): shard_degree_mix {tel['shard_degree_mix']}")
    check(set(tel["precision_mix"]) == {32},
          f"mesh (c): precision_mix {tel['precision_mix']}")
    log(f"mesh (c): a device_loss fault mid-wave: {len(degraded)} of "
        f"{MESH_WAVE} completions ok, mesh shrunk to {srv.mesh.devices} "
        f"device, {warmed} spare plans warmed, {cold} cold plans, "
        f"shard_degree_mix {tel['shard_degree_mix']}, precision_mix "
        f"{tel['precision_mix']}, the degraded wave's launches {counts}; "
        f"on {card}")


def mesh_rates(card):
    """(d) Served requests/s of the mesh tenant (2 logical devices) and of
    the same tenant on a single-device server, in alternating windows of
    whole rounds of the (b) trace (host clock, synchronized at both ends);
    logged, not checked."""
    import statistics
    import torch
    from repro_torch.models.frontends import init_cnn_frontend
    from repro_torch.runtime.server import AdaptiveServer
    trace = mesh_trace()
    plain = AdaptiveServer(max_batch=MAX_BATCH)
    plain.register("cnn", init_cnn_frontend(SEED), IMAGE)
    meshed = mesh_server(None, mesh_devices_by_name())
    arms = {"plain": plain, "mesh": meshed}
    for srv in arms.values():
        serve_window(srv, trace, 1)                 # warms plans
    rounds = -(-RATE_MIN_REQUESTS // len(trace))
    wall = serve_window(meshed, trace, rounds)
    rounds = max(rounds, math.ceil(rounds * 0.6 / wall))
    rates = {"plain": [], "mesh": []}
    for arm in ("plain", "mesh", "mesh", "plain") * (MESH_RATE_WINDOWS // 4):
        w = serve_window(arms[arm], trace, rounds)
        rates[arm].append(rounds * len(trace) / w)
    torch.cuda.synchronize()
    med = {arm: statistics.median(r) for arm, r in rates.items()}
    log(f"mesh (d): served {med['mesh']:.1f} requests/s on {MESH_DEVICES} "
        f"logical devices against {med['plain']:.1f} unsharded (ratio "
        f"{med['mesh'] / med['plain']:.3f}; windows of {rounds} rounds of "
        f"{len(trace)} requests, plain "
        f"{', '.join(f'{r:.1f}' for r in rates['plain'])}, mesh "
        f"{', '.join(f'{r:.1f}' for r in rates['mesh'])}; logged, not "
        f"checked) on {card}")
    return med


def mesh_phase(card, shapes, errs):
    """The "mesh" phase: (a)-(d) above.  Returns (d)'s rates."""
    from repro_torch.runtime.faults import INJECTOR
    t0 = time.perf_counter()
    try:
        mesh_execution_checks(card, shapes, errs)
        mesh_serving_checks(card)
        mesh_device_loss_checks(card)
        rates = mesh_rates(card)
    finally:
        INJECTOR.disarm()
    log(f"mesh phase: {time.perf_counter() - t0:.1f} s")
    return rates


def budget_pool_check(gen, errs):
    """``pool2d(mode="avg", budget=)`` under a VPU limit picks the im2col
    pool and launches it once."""
    import torch
    from repro_torch.core.resources import ResourceBudget
    from repro_torch.kernels import cuda
    from repro_torch.kernels.pool2d.mxu_im2col import pool2d_im2col_plain
    from repro_torch.kernels.pool2d.ops import pool2d
    x = torch.randn((4, 222, 222, 16), generator=gen).cuda()
    budget = ResourceBudget(vpu_ops_budget=5_000_000)
    cuda.reset_launches()
    y = pool2d(x, mode="avg", budget=budget)
    torch.cuda.synchronize()
    launches = cuda.launch_counts()
    check(launches == {"pool2d_im2col": 1},
          f"pool2d(budget=) launched {launches}")
    compare("pool2d_im2col", y, pool2d_im2col_plain(x, mode="avg"), 1e-6,
            1e-6, errs)
    log(f"pool2d(mode='avg', budget=vpu 5e6) at {tuple(x.shape)}: "
        f"launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 4, dual and matmul: the paper's dual-stream convs and the matmul
# family's single-stream members through their entry points
# ---------------------------------------------------------------------------
def operand(gen, shape, dtype, scale=1.0):
    """A seeded operand on the card: integers over their dtype's full
    range, floats standard normal times ``scale``."""
    import torch
    if dtype.is_floating_point:
        t = torch.randn(shape, generator=gen) * scale
    else:
        info = torch.iinfo(dtype)
        t = torch.randint(info.min, info.max + 1, shape, generator=gen,
                          dtype=dtype)
    return t.to(dtype).cuda()


def launched_once(fn, kernel, what):
    """Run ``fn`` with the counters reset just before and read just
    after; it must launch ``kernel`` exactly once and nothing else."""
    import torch
    from repro_torch.kernels import cuda
    cuda.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    got = cuda.launch_counts()
    check(got == {kernel: 1}, f"{what}: launched {got}, expected "
                              f"{{{kernel!r}: 1}}")
    return out


def dual_conv_checks(shapes, gen, errs):
    """``conv2d_dual(budget=)`` at both block shapes under DUAL_PLANS;
    returns the launches of those calls."""
    import torch
    from repro_torch.core.ip import SiteSpec
    from repro_torch.core.plan import plan_single
    from repro_torch.core.resources import ResourceBudget
    from repro_torch.kernels.conv2d.ip1_vpu import conv2d_ip1
    from repro_torch.kernels.conv2d.ip2_mxu import conv2d_ip2
    from repro_torch.kernels.conv2d.ip3_packed import (conv2d_ip3,
                                                       conv2d_ip3_plain)
    from repro_torch.kernels.conv2d.ip4_dual import (conv2d_ip4,
                                                     conv2d_ip4_plain)
    from repro_torch.kernels.conv2d.ops import conv2d_dual
    members = {"conv2d.ip3_packed": (conv2d_ip3, conv2d_ip3_plain,
                                     "conv2d_ip3"),
               "conv2d.ip4_dual": (conv2d_ip4, conv2d_ip4_plain,
                                   "conv2d_ip4")}
    launches = {}
    for block, (xs, ws) in shapes.items():
        for dname, budget_kw, member in DUAL_PLANS:
            dtype = getattr(torch, dname)
            kern, plain, name = members[member]
            scale = (ws[0] * ws[1] * ws[2]) ** -0.5
            xa, xb = operand(gen, xs, dtype), operand(gen, xs, dtype)
            w = operand(gen, ws, dtype, scale)
            budget = ResourceBudget(**budget_kw)
            planned = plan_single(SiteSpec.make(
                "conv2d", "conv2d", (xs, ws), dtype, dual=True),
                budget).ip.name
            what = f"{block} {dname} conv2d_dual(budget={budget_kw})"
            check(planned == member, f"{what}: planned {planned}, "
                                     f"expected {member}")
            ya, yb = launched_once(
                lambda: conv2d_dual(xa, xb, w, budget=budget), name, what)
            launches[name] = launches.get(name, 0) + 1
            pa, pb = plain(xa, xb, w)
            exact = not dtype.is_floating_point
            for got, want in ((ya, pa), (yb, pb)):
                compare(name, got, want, 1e-4, 1e-5, errs, exact=exact)
            single = {torch.float32: conv2d_ip2,
                      torch.int8: conv2d_ip1}.get(dtype)
            if single is not None:
                check(torch.equal(ya, single(xa, w))
                      and torch.equal(yb, single(xb, w)),
                      f"{what}: not bitwise equal to two "
                      f"{single.__name__} launches")
            check(all(torch.equal(u, v) for u, v in
                      zip(kern(xa, xb, w, block_cout=5), (ya, yb))),
                  f"{name}: result depends on block_cout")
            log(f"{what} -> {member}: one {name} launch; "
                f"{'bit-exact' if exact else 'within 1e-4'} against the "
                f"plain version"
                + (f", bitwise equal to two {single.__name__} launches"
                   if single is not None else ""))
        # bfloat16, Conv4's fourth operand type (widened exactly to f32)
        xa, xb = (operand(gen, xs, torch.bfloat16) for _ in range(2))
        w = operand(gen, ws, torch.bfloat16, (ws[0] * ws[1] * ws[2]) ** -0.5)
        for got, want in zip(conv2d_ip4(xa, xb, w),
                             conv2d_ip4_plain(xa, xb, w)):
            compare("conv2d_ip4", got, want, 1e-4, 1e-5, errs)
    torch.cuda.synchronize()
    return launches


def matmul_checks(gen, errs):
    """``matmul(budget=, ladder=)`` under MATMUL_PLANS and
    ``int8_matmul(use_kernel=True)`` at FFN; returns their launches."""
    import torch
    from repro_torch.core.ip import SiteSpec
    from repro_torch.core.plan import plan_single
    from repro_torch.core.resources import ResourceBudget
    from repro_torch.kernels.matmul.mxu import (mm_mxu, mm_mxu_plain,
                                                mm_vpu, mm_vpu_plain)
    from repro_torch.kernels.matmul.ops import matmul
    from repro_torch.quant.quantize import (fake_quant, int8_matmul,
                                            quantize_acts, quantize_weights)
    m, k, n = FFN
    ops = {"float32": (operand(gen, (m, k), torch.float32),
                       operand(gen, (k, n), torch.float32)),
           "int8": (operand(gen, (m, k), torch.int8),
                    operand(gen, (k, n), torch.int8))}
    launches = {}
    for dname, ladder, budget_kw, want, kernel in MATMUL_PLANS:
        a, b = ops[dname]
        budget = ResourceBudget(**budget_kw)
        p = plan_single(SiteSpec.make("matmul", "matmul", (a.shape, b.shape),
                                      a.dtype, ladder=ladder, dual=False),
                        budget)
        what = (f"{dname} matmul(ladder={ladder}, budget={budget_kw}) at "
                f"{FFN}")
        got_plan = f"{p.ip.name}@{p.precision_bits}"
        check(got_plan == want, f"{what}: planned {got_plan}, expected "
                                f"{want}")
        y = launched_once(lambda: matmul(a, b, budget=budget, ladder=ladder),
                          kernel, what)
        row = mm_row(kernel, torch.int8 if p.precision_bits == 8
                     else a.dtype)
        launches[row] = launches.get(row, 0) + 1
        if p.precision_bits == 8 and dname == "float32":
            # quantized_matmul's own steps around the int32 accumulator
            aq, bq = quantize_acts(a, bits=8), quantize_weights(b, bits=8)
            ref = (mm_mxu_plain(aq.q, bq.q).to(torch.float32)
                   * (aq.scale * bq.scale.reshape(1, -1)))
            compare(row, y, ref, 0, 0, errs, exact=True)
        elif p.precision_bits == 16:
            ref = mm_vpu_plain(fake_quant(a, bits=16),
                               fake_quant(b, bits=16, axis=-1))
            compare(row, y, ref, MM_TOL["rtol"], MM_TOL["atol"], errs)
        else:
            compare(row, y, mm_mxu_plain(a, b), MM_TOL["rtol"],
                    MM_TOL["atol"], errs, exact=dname == "int8")
        log(f"{what} -> {want}: one {kernel} launch")
    x, w = ops["float32"]
    wq = quantize_weights(w)
    y = launched_once(lambda: int8_matmul(x, wq, use_kernel=True), "mm_mxu",
                      "int8_matmul(use_kernel=True)")
    launches["mm_mxu (int8)"] += 1
    check(torch.equal(y, int8_matmul(x, wq)),
          "int8_matmul: the kernel path differs from use_kernel=False")
    log(f"int8_matmul(use_kernel=True) at {FFN}: one mm_mxu launch, "
        f"bitwise equal to use_kernel=False")
    for dname, (a, b) in ops.items():
        base = mm_mxu(a, b)
        for tiles in (dict(bm=64, bn=32, bk=16), dict(bm=128, bn=512,
                                                      bk=1024)):
            check(torch.equal(mm_mxu(a, b, **tiles), base),
                  f"mm_mxu {dname}: result depends on {tiles}")
        check(torch.equal(mm_vpu(a, b, bm=8, bn=16), base),
              f"{dname}: mm_vpu and mm_mxu differ")
    a, b = (t.to(torch.bfloat16) for t in ops["float32"])
    compare("mm_mxu (bf16)", mm_mxu(a, b), mm_mxu_plain(a, b),
            MM_TOL["rtol"], MM_TOL["atol"], errs)
    compare(mm_row("mm_vpu", a.dtype), mm_vpu(a, b), mm_vpu_plain(a, b),
            MM_TOL["rtol"], MM_TOL["atol"], errs)
    log("mm_mxu bitwise independent of bm/bn/bk; mm_vpu == mm_mxu bitwise "
        "(f32 and int8); bf16 within tolerance")
    tc_ragged_checks(gen, errs)
    f32_ragged_checks(gen, errs)
    torch.cuda.synchronize()
    return launches


def f32_ragged_checks(gen, errs):
    """f32 ``mm_mxu`` (the CUDA-core kernel, ``mm_mxu_f32_kernel``) at
    TC_RAGGED against its plain version within MM_TOL, one launch a
    call, and bitwise equal to ``mm_vpu`` (one FMA chain over k); f32
    ``mm_dual_full`` (``mm_dual_f32_kernel``) at TC_RAGGED, one launch a
    call, each stream bitwise equal to ``mm_mxu``."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.kernels.matmul.dual import mm_dual_full
    from repro_torch.kernels.matmul.mxu import mm_mxu, mm_mxu_plain, mm_vpu
    for m, k, n in TC_RAGGED:
        a = operand(gen, (m, k), torch.float32)
        b = operand(gen, (k, n), torch.float32)
        cuda.reset_launches()
        y = mm_mxu(a, b)
        check(cuda.launch_counts() == {"mm_mxu": 1},
              f"f32 mm_mxu at {(m, k, n)}: launches {cuda.launch_counts()}")
        compare("mm_mxu", y, mm_mxu_plain(a, b), MM_TOL["rtol"],
                MM_TOL["atol"], errs)
        check(torch.equal(mm_vpu(a, b), y),
              f"f32 at {(m, k, n)}: mm_vpu and mm_mxu differ")
    log(f"f32 mm_mxu ({KERNEL['mm_mxu']}) at ragged (M, K, N) {TC_RAGGED}: "
        f"one launch a call, within MM_TOL, bitwise equal to mm_vpu")
    for m, k, n in TC_RAGGED:
        a1, a2 = (operand(gen, (m, k), torch.float32) for _ in range(2))
        b = operand(gen, (k, n), torch.float32)
        cuda.reset_launches()
        ys = mm_dual_full(a1, a2, b)
        check(cuda.launch_counts() == {"mm_dual_full": 1},
              f"f32 mm_dual_full at {(m, k, n)}: launches "
              f"{cuda.launch_counts()}")
        check(all(torch.equal(y, mm_mxu(a, b)) for y, a in zip(ys, (a1, a2))),
              f"f32 mm_dual_full at {(m, k, n)}: not bitwise equal to two "
              f"mm_mxu launches")
    log(f"f32 mm_dual_full ({KERNEL['mm_dual_full (f32)']}) at ragged (M, K, "
        f"N) {TC_RAGGED}: one launch a call, each stream bitwise equal to "
        f"mm_mxu")


def tc_ragged_checks(gen, errs):
    """The tensor-core route at TC_RAGGED on int8 and bf16: ``mm_mxu``
    against its plain version (int8 bit-exact, bf16 within MM_TOL), and
    ``mm_dual_full`` (on int8 ``mm_dual_shared`` too) bitwise equal to
    two ``mm_mxu`` launches."""
    import torch
    from repro_torch.kernels.matmul.dual import mm_dual_full, mm_dual_shared
    from repro_torch.kernels.matmul.mxu import mm_mxu, mm_mxu_plain
    for dtype in (torch.int8, torch.bfloat16):
        exact = dtype == torch.int8
        row = mm_row("mm_mxu", dtype)
        duals = (("mm_dual_full", mm_dual_full),) + (
            (("mm_dual_shared", mm_dual_shared),) if exact else ())
        for m, k, n in TC_RAGGED:
            a1, a2 = (operand(gen, (m, k), dtype) for _ in range(2))
            b = operand(gen, (k, n), dtype)
            ys = mm_mxu(a1, b), mm_mxu(a2, b)
            for y, a in zip(ys, (a1, a2)):
                compare(row, y, mm_mxu_plain(a, b), MM_TOL["rtol"],
                        MM_TOL["atol"], errs, exact=exact)
            for name, dual in duals:
                check(all(torch.equal(u, v)
                          for u, v in zip(dual(a1, a2, b), ys)),
                      f"{name} {dtype} at {(m, k, n)}: not bitwise equal "
                      f"to two mm_mxu launches")
    log(f"tensor-core route at ragged (M, K, N) {TC_RAGGED}: mm_mxu int8 "
        f"bit-exact and bf16 within MM_TOL; mm_dual_full (and int8 "
        f"mm_dual_shared) bitwise equal to two mm_mxu launches")


# ---------------------------------------------------------------------------
# Phase 4, lm sites: the budget sweep's LM sites, planned and executed
# ---------------------------------------------------------------------------
def lm_network_specs(budget):
    """The port's copy of ``examples/budget_sweep.py::lm_network_specs``
    at LLAMA's widths."""
    import torch
    from repro_torch.core.ip import SiteSpec
    d, f = LLAMA["d_model"], LLAMA["d_ff"]
    hq, hkv, hd = LLAMA["n_heads"], LLAMA["n_kv_heads"], LLAMA["head_dim"]
    dual = budget.prefer_parallel_streams
    mm_dtype = torch.int8 if budget.precision_bits <= 8 else torch.bfloat16
    return [
        SiteSpec.make("conv3x3", "conv2d", ((8, 64, 64, 16), (3, 3, 16, 32)),
                      torch.int8, dual=dual),
        SiteSpec.make("ffn", "matmul", ((4096, d), (d, f)), mm_dtype,
                      ladder=(8,), dual=dual),
        SiteSpec.make("attn_train4k", "attention",
                      ((8, hq, 4096, hd), (8, hkv, 4096, hd)),
                      torch.bfloat16),
        SiteSpec.make("attn_decode32k", "attention",
                      ((128, hq, 1, hd), (128, hkv, 32768, hd)),
                      torch.bfloat16),
    ]


def plan_lm_sweep():
    """Plan the LM sites under each of LM_BUDGETS as the sweep does: one
    joint ``plan_network``, else ``select_ip`` per site (at the site's
    native width).  Returns each budget's row of cells, as the sweep
    prints them, and its sites as (spec, member, bits, lowered), None
    where the site is infeasible."""
    from repro_torch.core.plan import plan_network, select_ip
    from repro_torch.core.resources import ResourceBudget
    table, sites_of = {}, {}
    for name, kw in LM_BUDGETS.items():
        budget = ResourceBudget(**kw)
        specs = lm_network_specs(budget)
        try:
            plan = plan_network(specs, budget)
            sites = [(s, plan.site(s.name).ip.name.split(".")[-1],
                      plan.site(s.name).precision_bits,
                      plan.site(s.name).lowered) for s in specs]
            cells = [f"{m}@{bits}b" + ("*" if lowered else "")
                     for _, m, bits, lowered in sites]
        except ValueError:
            sites, cells = [], []
            for s in specs:
                try:
                    m = select_ip(s.family, s, budget=budget).name
                except ValueError:
                    sites.append(None)
                    cells.append("infeasible")
                    continue
                m = m.split(".")[-1]
                sites.append((s, m, s.native_bits, False))
                cells.append(m + "!")
        table[name], sites_of[name] = tuple(cells), sites
    return table, sites_of


def lm_site_runs(sites_of):
    """The distinct (site, member, bits, lowered) of the planned sites,
    in table order."""
    runs = []
    for sites in sites_of.values():
        for site in sites:
            if site is None:
                continue
            spec, member, bits, lowered = site
            run = (spec.name, member, bits, lowered)
            if run not in runs:
                runs.append(run)
    return runs


def np_operand(rng, shape, dtype, scale=1.0):
    """A numpy-seeded operand on the card: integers over their dtype's
    full range, floats standard normal times ``scale`` (made in f32 and
    cast on the card)."""
    import numpy as np
    import torch
    if dtype.is_floating_point:
        t = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        if scale != 1.0:
            t.mul_(scale)
        return t.cuda().to(dtype)
    info = torch.iinfo(dtype)
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    return torch.from_numpy(rng.integers(info.min, info.max + 1, shape,
                                         dtype=np_dtype)).cuda()


def attention_chunks(q, k, v, per_head):
    """(q, k, v) slices of one batch row (and one kv head with its GQA
    group of q heads): the plain versions materialize f32 scores of a
    whole slice, so the full-size ones run a slice at a time."""
    group = q.shape[1] // k.shape[1]
    for b in range(q.shape[0]):
        heads = range(k.shape[1]) if per_head else (None,)
        for h in heads:
            if h is None:
                yield (b, slice(None)), q[b:b + 1], k[b:b + 1], v[b:b + 1]
            else:
                qs = slice(h * group, (h + 1) * group)
                yield ((b, qs), q[b:b + 1, qs], k[b:b + 1, h:h + 1],
                       v[b:b + 1, h:h + 1])


def compare_attention(name, got, plain, q, k, v, per_head, tol, errs,
                      **kw):
    """``got`` against ``plain`` over the slices of ``attention_chunks``
    within ``tol``; records and logs the max abs error."""
    import torch
    err = 0.0
    for (b, qs), qc, kc, vc in attention_chunks(q, k, v, per_head):
        want = plain(qc, kc, vc, **kw)
        g = got[b:b + 1, qs]
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
        torch.testing.assert_close(g, want, **tol,
                                   msg=lambda m: f"{name}: {m}")
        err = max(err, float((g.double() - want.double()).abs().max()))
    errs[name] = max(errs.get(name, 0.0), err)
    log(f"{name} at q{tuple(q.shape)} kv{tuple(k.shape)} {q.dtype}: ok "
        f"against the plain version slice by slice (max abs err {err:.3e}"
        f", rtol={tol['rtol']}, atol={tol['atol']})")


def lm_site_checks(sites_of, rng, errs):
    """Run each distinct planned site of the table once on the card
    through its op wrapper: it must launch its member's kernel exactly
    once; results against the plain versions.  Returns the launches and
    the operands (for the times)."""
    import torch
    from repro_torch.core.resources import ResourceBudget
    from repro_torch.kernels.attention.decode import flash_decode_plain
    from repro_torch.kernels.attention.flash import flash_attention_plain
    from repro_torch.kernels.attention.ops import attention
    from repro_torch.kernels.conv2d.ip1_vpu import conv2d_ip1_plain
    from repro_torch.kernels.conv2d.ip3_packed import conv2d_ip3_plain
    from repro_torch.kernels.conv2d.ops import conv2d, conv2d_dual
    from repro_torch.kernels.matmul.dual import mm_dual_shared_plain
    from repro_torch.kernels.matmul.mxu import mm_mxu_plain, mm_vpu_plain
    from repro_torch.kernels.matmul.ops import matmul, matmul_dual
    from repro_torch.quant.ops import quantized_matmul
    from repro_torch.quant.quantize import quantize_acts, quantize_weights
    specs = {site[0].name: site[0] for site in sites_of["ample"]}
    (xs, ws), (as_, bs_) = specs["conv3x3"].shapes, specs["ffn"].shapes
    (qs, kvs), (dqs, dkvs) = (specs["attn_train4k"].shapes,
                              specs["attn_decode32k"].shapes)
    i8, bf16 = torch.int8, torch.bfloat16
    ops = {"conv": [np_operand(rng, s, i8) for s in (xs, xs, ws)],
           "ffn_i8": [np_operand(rng, s, i8) for s in (as_, as_, bs_)],
           "ffn_bf16": [np_operand(rng, s, bf16) for s in (as_, as_, bs_)],
           "train": [np_operand(rng, s, bf16) for s in (qs, kvs, kvs)],
           "decode": [np_operand(rng, s, bf16) for s in (dqs, dkvs, dkvs)]}
    launches = {}
    for site, member, bits, lowered in lm_site_runs(sites_of):
        kernel = row = MEMBER_KERNEL[member]
        what = f"{site} {member}@{bits}b{'*' if lowered else ''}"
        if site == "conv3x3":
            xa, xb, w = ops["conv"]
            if member == "ip3_packed":
                ys = launched_once(lambda: conv2d_dual(xa, xb, w, ip=member),
                                   kernel, what)
                for got, want in zip(ys, conv2d_ip3_plain(xa, xb, w)):
                    compare(kernel, got, want, 0, 0, errs, exact=True)
            else:
                y = launched_once(lambda: conv2d(xa, w, ip=member), kernel,
                                  what)
                compare(kernel, y, conv2d_ip1_plain(xa, w), 0, 0, errs,
                        exact=True)
        elif site == "ffn" and lowered:
            a, _, b = ops["ffn_bf16"]
            y = launched_once(lambda: quantized_matmul(a, b, bits=bits,
                                                       ip=member),
                              kernel, what)
            aq, bq = quantize_acts(a, bits=8), quantize_weights(b, bits=8)
            want = (mm_vpu_plain(aq.q, bq.q).to(torch.float32)
                    * (aq.scale * bq.scale.reshape(1, -1)))
            row = mm_row(kernel, aq.q.dtype)
            compare(row, y, want, 0, 0, errs, exact=True)
        elif site == "ffn":
            a1, a2, b = ops["ffn_i8" if bits == 8 else "ffn_bf16"]
            if member == "mm_dual_shared":
                ys = launched_once(lambda: matmul_dual(a1, a2, b, ip=member),
                                   kernel, what)
                for got, want in zip(ys, mm_dual_shared_plain(a1, a2, b)):
                    compare(kernel, got, want, 0, 0, errs, exact=True)
            else:
                y = launched_once(lambda: matmul(a1, b, ip=member), kernel,
                                  what)
                want = (mm_mxu_plain if member == "mm_mxu"
                        else mm_vpu_plain)(a1, b)
                row = mm_row(kernel, a1.dtype)
                compare(row, y, want, MM_TOL["rtol"], MM_TOL["atol"],
                        errs, exact=bits == 8)
        elif site == "attn_train4k":
            q, k, v = ops["train"]
            y = launched_once(lambda: attention(q, k, v, ip=member), kernel,
                              what)
            compare_attention(kernel, y, flash_attention_plain, q, k, v,
                              True, ATTN_BF16_TOL, errs, causal=True)
        else:
            q, k, v = ops["decode"]
            y = launched_once(lambda: attention(q, k, v, ip=member), kernel,
                              what)
            compare_attention(kernel, y, flash_decode_plain, q, k, v, False,
                              ATTN_BF16_TOL, errs)
        launches[row] = launches.get(row, 0) + 1
        log(f"{what}: one {kernel} launch")
    for name in ("train", "decode"):
        q, k, v = ops[name]
        try:
            attention(q, k, v, budget=ResourceBudget(mxu_available=False))
        except ValueError as e:
            check("no feasible IP" in str(e), f"attention {name}: {e}")
        else:
            raise SmokeFailure(f"attention {name} planned with no MXU")
    log("attention(budget=ResourceBudget(mxu_available=False)) raises "
        "'no feasible IP' at both attention sites")
    torch.cuda.synchronize()
    return launches, ops


def lm_kernel_checks(ops, rng, errs):
    """The three new kernels beyond the planned sites: f32 attention and
    decode at ATTN_F32_CASES / DECODE_F32_CASES and at the planned
    sites' full shapes, rows that see no key written as 0; split-KV
    decode at DECODE_SPLIT_CASES in bf16 and f32, one launch a call, and
    the splits the launcher chose at attn_decode32k; bf16 attention (the
    tensor-core kernel) at ATTN_BF16_CASES;
    ``matmul_dual(budget=ResourceBudget())`` on bf16 plans
    ``mm_dual_full`` (one launch), and f32/bf16 ``mm_dual_full`` equal
    two ``mm_mxu`` launches bitwise; int8 ``mm_dual_full`` bit-exact.
    Returns the launches of the planned ``matmul_dual`` call."""
    import torch
    from repro_torch.core.ip import SiteSpec
    from repro_torch.core.plan import plan_single
    from repro_torch.core.resources import ResourceBudget
    from repro_torch.kernels import cuda
    from repro_torch.kernels.attention.decode import (decode_plan,
                                                      flash_decode,
                                                      flash_decode_plain)
    from repro_torch.kernels.attention.flash import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.matmul.dual import (mm_dual_full,
                                                 mm_dual_full_plain,
                                                 mm_dual_shared)
    from repro_torch.kernels.matmul.mxu import mm_mxu
    from repro_torch.kernels.matmul.ops import matmul_dual
    f32 = torch.float32
    for b, hq, hkv, sq, skv, d in ATTN_F32_CASES:
        q = np_operand(rng, (b, hq, sq, d), f32)
        k, v = (np_operand(rng, (b, hkv, skv, d), f32) for _ in range(2))
        for causal in (True, False):
            y = flash_attention(q, k, v, causal=causal)
            compare("flash_attention", y,
                    flash_attention_plain(q, k, v, causal=causal),
                    ATTN_F32_TOL["rtol"], ATTN_F32_TOL["atol"], errs)
            if causal and sq > skv:
                check(bool((y[:, :, :sq - skv] == 0).all()),
                      "flash_attention: a row that sees no key is not 0")
    for b, hq, hkv, skv, d in DECODE_F32_CASES:
        q = np_operand(rng, (b, hq, 1, d), f32)
        k, v = (np_operand(rng, (b, hkv, skv, d), f32) for _ in range(2))
        compare("flash_decode", flash_decode(q, k, v),
                flash_decode_plain(q, k, v), ATTN_F32_TOL["rtol"],
                ATTN_F32_TOL["atol"], errs)
    log(f"f32 flash_attention ({len(ATTN_F32_CASES)} cases, causal and "
        f"not) and flash_decode ({len(DECODE_F32_CASES)} cases) within "
        f"rtol={ATTN_F32_TOL['rtol']}, atol={ATTN_F32_TOL['atol']}; rows "
        f"that see no key are 0")
    # the planned sites' full shapes in f32: their bf16 operands widened
    for name, per_head, kernel, plain, kw in (
            ("train", True, flash_attention, flash_attention_plain,
             dict(causal=True)),
            ("decode", False, flash_decode, flash_decode_plain, {})):
        q, k, v = (t.to(f32) for t in ops[name])
        compare_attention(kernel.__name__, kernel(q, k, v, **kw), plain, q,
                          k, v, per_head, ATTN_F32_TOL, errs, **kw)
        del q, k, v
    # split-KV edge cases (many splits with a short last one, row blocks
    # of a large group; a group of 256 x 128 runs since row blocks lifted
    # the group limit), one launch a call
    chosen = []
    for b, hq, hkv, skv, d in DECODE_SPLIT_CASES:
        for dtype, tol in ((torch.bfloat16, ATTN_BF16_TOL),
                           (f32, ATTN_F32_TOL)):
            q = np_operand(rng, (b, hq, 1, d), dtype)
            k, v = (np_operand(rng, (b, hkv, skv, d), dtype)
                    for _ in range(2))
            chosen.append(decode_plan(q, k)[0])
            cuda.reset_launches()
            y = flash_decode(q, k, v)
            check(cuda.launch_counts() == {"flash_decode": 1},
                  f"flash_decode at {(b, hq, hkv, skv, d)}: launches "
                  f"{cuda.launch_counts()}")
            compare("flash_decode", y, flash_decode_plain(q, k, v),
                    tol["rtol"], tol["atol"], errs)
    log(f"flash_decode (split-KV) at {len(DECODE_SPLIT_CASES)} edge cases, "
        f"bf16 and f32, one launch a call, within ATTN_BF16_TOL / "
        f"ATTN_F32_TOL; splits chosen {chosen}")
    splits, resident, ws_floats = decode_plan(*ops["decode"][:2])
    log(f"flash_decode at attn_decode32k: {splits} splits, {resident} "
        f"resident CTAs an SM, workspace {ws_floats * 4} bytes")
    # bf16 flash (the tensor-core kernel) at the f32 cases' shapes
    bf16 = torch.bfloat16
    for b, hq, hkv, sq, skv, d in ATTN_BF16_CASES:
        q = np_operand(rng, (b, hq, sq, d), bf16)
        k, v = (np_operand(rng, (b, hkv, skv, d), bf16) for _ in range(2))
        for causal in (True, False):
            y = flash_attention(q, k, v, causal=causal)
            compare("flash_attention", y,
                    flash_attention_plain(q, k, v, causal=causal),
                    ATTN_BF16_TOL["rtol"], ATTN_BF16_TOL["atol"], errs)
            if causal and sq > skv:
                check(bool((y[:, :, :sq - skv] == 0).all()),
                      "bf16 flash_attention: a row that sees no key is not "
                      "0")
    log(f"bf16 flash_attention (attn_tc_flash_kernel, wgmma) at "
        f"{len(ATTN_BF16_CASES)} shapes, causal and not, within "
        f"rtol={ATTN_BF16_TOL['rtol']}, atol={ATTN_BF16_TOL['atol']}; rows "
        f"that see no key are 0")

    a1, a2, b = ops["ffn_bf16"]
    spec = SiteSpec.make("matmul", "matmul", (a1.shape, b.shape), a1.dtype,
                         dual=True)
    planned = plan_single(spec, ResourceBudget()).ip.name
    check(planned == "matmul.mm_dual_full",
          f"bf16 matmul_dual planned {planned}")
    what = f"bf16 matmul_dual(budget=ResourceBudget()) at {tuple(a1.shape)}"
    ys = launched_once(lambda: matmul_dual(a1, a2, b,
                                           budget=ResourceBudget()),
                       "mm_dual_full", what)
    launches = {"mm_dual_full": 1}
    for dtype, (x1, x2, w) in ((torch.bfloat16, (a1, a2, b)),
                               (f32, [t.to(f32) for t in (a1, a2, b)])):
        if dtype == f32:
            ys = mm_dual_full(x1, x2, w)
        check(all(torch.equal(y, mm_mxu(x, w)) for y, x in zip(ys, (x1, x2))),
              f"{dtype} mm_dual_full: not bitwise equal to two mm_mxu "
              f"launches")
        for got, want in zip(ys, mm_dual_full_plain(x1, x2, w)):
            compare("mm_dual_full", got, want, MM_TOL["rtol"],
                    MM_TOL["atol"], errs)
    i1, i2, ib = ops["ffn_i8"]
    for got, want in zip(mm_dual_full(i1, i2, ib),
                         mm_dual_full_plain(i1, i2, ib)):
        compare("mm_dual_full", got, want, 0, 0, errs, exact=True)
    cuda.reset_launches()
    try:
        mm_dual_shared(a1, a2, b)
    except TypeError:
        check(cuda.launch_counts() == {}, "mm_dual_shared launched on bf16")
    else:
        raise SmokeFailure("mm_dual_shared took bf16 operands")
    log(f"{what} -> mm_dual_full: one launch; bf16 and f32 bitwise equal "
        f"to two mm_mxu launches; int8 bit-exact; mm_dual_shared refuses "
        f"bf16 before any launch")
    # f32 matmul_dual through the planner: mm_dual_full on the CUDA-core
    # kernel (mm_dual_f32_kernel), one launch, each stream mm_mxu's
    f1, f2, fb = (t.to(f32) for t in (a1, a2, b))
    spec = SiteSpec.make("matmul", "matmul", (f1.shape, fb.shape), f32,
                         dual=True)
    planned = plan_single(spec, ResourceBudget()).ip.name
    check(planned == "matmul.mm_dual_full",
          f"f32 matmul_dual planned {planned}")
    what = f"f32 matmul_dual(budget=ResourceBudget()) at {tuple(f1.shape)}"
    ys = launched_once(lambda: matmul_dual(f1, f2, fb,
                                           budget=ResourceBudget()),
                       "mm_dual_full", what)
    launches["mm_dual_full (f32)"] = 1
    check(all(torch.equal(y, mm_mxu(x, fb)) for y, x in zip(ys, (f1, f2))),
          f"{what}: not bitwise equal to two mm_mxu launches")
    for got, want in zip(ys, mm_dual_full_plain(f1, f2, fb)):
        compare("mm_dual_full (f32)", got, want, MM_TOL["rtol"],
                MM_TOL["atol"], errs)
    log(f"{what} -> mm_dual_full ({KERNEL['mm_dual_full (f32)']}): one "
        f"launch, each stream bitwise equal to mm_mxu, within MM_TOL")
    del f1, f2, fb, ys
    torch.cuda.synchronize()
    return launches


def time_sync_ms(fn, reps=3):
    """Median device time (ms) of one call of ``fn`` over ``reps`` calls,
    each between two CUDA events and synchronized after: for the chunked
    plain versions, whose hundreds of launches a call would fill the
    launch queue behind ``time_ms``'s sleep kernel.  The host's issue time
    between a call's launches counts."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def visible_pairs(sq, skv, causal):
    """(query, key) pairs a head's attention computes: all of them, or
    under the bottom-right causal mask those with j <= i + skv - sq."""
    if not causal:
        return sq * skv
    offs = skv - sq
    return sum(min(skv, max(0, i + offs + 1)) for i in range(sq))


def lm_timings(ops, peaks, errs):
    """Rows for the three new kernels at the planned sites' shapes:
    ``mm_dual_shared`` (int8) and ``mm_dual_full`` (bf16, and f32 on the
    operands widened) at the sweep's FFN, ``flash_attention`` at attn_train4k, ``flash_decode`` at
    attn_decode32k (bf16, and f32 on the cache widened).  Bound by bytes
    or by the tensor-core peak of the operand type; the FP32 figure
    beside it.  The f32 flash row's output is held to ATTN_F32_TOL
    against the plain version head chunk by head chunk."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention.decode import (flash_decode,
                                                      flash_decode_plain)
    from repro_torch.kernels.attention.flash import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.matmul.dual import (mm_dual_full,
                                                 mm_dual_full_plain,
                                                 mm_dual_shared,
                                                 mm_dual_shared_plain)
    from repro_torch.kernels.matmul.mxu import mm_mxu
    rows = {}

    def row(kern, plain_ms, library_ms, n_bytes, n_ops, rate, shape,
            library):
        b_ms, by = bound_ms(peaks, n_bytes, n_ops, rate)
        return dict(ms=time_ms(kern), plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=b_ms, bound_by=by,
                    fp32_bound_ms=bound_ms(peaks, n_bytes, n_ops)[0],
                    shape=shape, library=library)

    a1, a2, b = ops["ffn_i8"]
    m, k = a1.shape
    n = b.shape[1]
    y1, y2 = mm_dual_shared(a1, a2, b)
    two_mxu = ("two mm_mxu launches",
               time_ms(lambda: (mm_mxu(a1, b), mm_mxu(a2, b))))
    rows["mm_dual_shared"] = row(
        lambda: mm_dual_shared(a1, a2, b),
        time_ms(lambda: mm_dual_shared_plain(a1, a2, b)),
        time_ms(lambda: (torch._int_mm(a1, b), torch._int_mm(a2, b))),
        nbytes(a1, a2, b, y1, y2), 4 * m * k * n, "int8_tensor_ops",
        f"2 x ({m}, {k}) x ({k}, {n}) int8", "two torch._int_mm")
    rows["mm_dual_shared"]["yardstick"] = two_mxu
    a1, a2, b = ops["ffn_bf16"]
    y1, y2 = mm_dual_full(a1, a2, b)
    two_mxu = ("two mm_mxu launches",
               time_ms(lambda: (mm_mxu(a1, b), mm_mxu(a2, b))))
    rows["mm_dual_full"] = row(
        lambda: mm_dual_full(a1, a2, b),
        time_ms(lambda: mm_dual_full_plain(a1, a2, b)),
        time_ms(lambda: (torch.matmul(a1, b), torch.matmul(a2, b))),
        nbytes(a1, a2, b, y1, y2), 4 * m * k * n, "bf16_tensor_flops",
        f"2 x ({m}, {k}) x ({k}, {n}) bf16", "two bf16 torch.matmul")
    rows["mm_dual_full"]["yardstick"] = two_mxu
    # f32 mm_dual_full (mm_dual_f32_kernel on CUDA cores) at the same shape
    f1, f2, fb = (t.to(torch.float32) for t in (a1, a2, b))
    y1, y2 = mm_dual_full(f1, f2, fb)
    rows["mm_dual_full (f32)"] = row(
        lambda: mm_dual_full(f1, f2, fb),
        time_ms(lambda: mm_dual_full_plain(f1, f2, fb)),
        time_ms(lambda: (torch.matmul(f1, fb), torch.matmul(f2, fb))),
        nbytes(f1, f2, fb, y1, y2), 4 * m * k * n, "fp32_flops",
        f"2 x ({m}, {k}) x ({k}, {n}) f32", "two torch.matmul")
    rows["mm_dual_full (f32)"]["yardstick"] = (
        "two mm_mxu launches",
        time_ms(lambda: (mm_mxu(f1, fb), mm_mxu(f2, fb))))

    def plain_chunks(plain, q, k, v, per_head, **kw):
        for _, qc, kc, vc in attention_chunks(q, k, v, per_head):
            plain(qc, kc, vc, **kw)

    def sdpa(q, k, v, causal):
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)

    for name, kern, plain, key, causal in (
            ("flash_attention", flash_attention, flash_attention_plain,
             "train", True),
            ("flash_decode", flash_decode, flash_decode_plain, "decode",
             False)):
        q, k, v = ops[key]
        y = kern(q, k, v)
        bsz, hq, sq, d = q.shape
        skv = k.shape[2]
        kw = dict(causal=True) if name == "flash_attention" else {}
        per_head = name == "flash_attention"
        n_ops = 4 * d * bsz * hq * visible_pairs(sq, skv, causal)
        rows[name] = row(
            lambda: kern(q, k, v),
            time_sync_ms(lambda: plain_chunks(plain, q, k, v, per_head,
                                              **kw)),
            time_ms(sdpa(q, k, v, causal and sq == skv)),
            nbytes(q, k, v, y), n_ops, "bf16_tensor_flops",
            f"q{tuple(q.shape)} kv{tuple(k.shape)} bf16"
            + (" causal" if causal else ""),
            "F.scaled_dot_product_attention(enable_gqa=True)")
        if name == "flash_attention":
            # the operations term: the larger of the tensor operations and
            # the exponentials (one a visible pair) at the MUFU rate
            r = rows[name]
            r["exp_bound_ms"] = bound_ms(
                peaks, 0, bsz * hq * visible_pairs(sq, skv, causal),
                "mufu_per_s")[0]
            if r["exp_bound_ms"] > r["bound_ms"]:
                r["bound_ms"], r["bound_by"] = r["exp_bound_ms"], "operations"
    # the flash kernel's f32 instance at attn_train4k (the bf16 operands
    # widened; CUDA cores): bound by the FP32 rate or the exponentials
    q, k, v = (t.float() for t in ops["train"])
    y = flash_attention(q, k, v, causal=True)
    compare_attention("flash_attention (f32)", y, flash_attention_plain, q,
                      k, v, True, ATTN_F32_TOL, errs, causal=True)
    bsz, hq, sq, d = q.shape
    pairs = bsz * hq * visible_pairs(sq, k.shape[2], True)
    rows["flash_attention (f32)"] = row(
        lambda: flash_attention(q, k, v, causal=True),
        time_sync_ms(lambda: plain_chunks(flash_attention_plain, q, k, v,
                                          True, causal=True)),
        time_ms(sdpa(q, k, v, True)), nbytes(q, k, v, y), 4 * d * pairs,
        "fp32_flops", f"q{tuple(q.shape)} kv{tuple(k.shape)} f32 causal",
        "F.scaled_dot_product_attention(enable_gqa=True)")
    r = rows["flash_attention (f32)"]
    r["exp_bound_ms"] = bound_ms(peaks, 0, pairs, "mufu_per_s")[0]
    if r["exp_bound_ms"] > r["bound_ms"]:
        r["bound_ms"], r["bound_by"] = r["exp_bound_ms"], "operations"
    del q, k, v, y
    # the decode kernel's f32 instance at attn_decode32k (the bf16 cache
    # widened: twice the bytes), beside f32 SDPA with enable_gqa (TF32
    # off); where SDPA's f32 path cannot run (its GQA expansion of the
    # 17 GB cache to every query head), the error it raises stands in the
    # row instead of a time
    q, k, v = (t.float() for t in ops["decode"])
    y = flash_decode(q, k, v)
    try:
        lib_ms, lib_note = (time_ms(sdpa(q, k, v, False)),
                            "f32 F.scaled_dot_product_attention(enable_gqa="
                            "True)")
    except RuntimeError as e:
        lib_ms = None
        lib_note = (f"f32 F.scaled_dot_product_attention(enable_gqa=True) "
                    f"raised {type(e).__name__}: "
                    f"{str(e).splitlines()[0][:240]}")
    torch.cuda.empty_cache()
    rows["flash_decode (f32)"] = row(
        lambda: flash_decode(q, k, v),
        time_sync_ms(lambda: plain_chunks(flash_decode_plain, q, k, v,
                                          False)),
        lib_ms, nbytes(q, k, v, y),
        4 * q.shape[-1] * q.shape[0] * q.shape[1] * k.shape[2], "fp32_flops",
        f"q{tuple(q.shape)} kv{tuple(k.shape)} f32", lib_note)
    del q, k, v, y
    return rows


def sass_check(lib_path):
    """``cuobjdump -sass`` of the built library: the LOGIC_ONLY and
    CUDA_CORE kernels contain no MMA instruction, the TC_SASS ones only
    their wgmma kind.  Returns the MMA count of every kernel."""
    import re
    from repro_torch.kernels import cuda
    tool = Path(cuda._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    parts = re.split(r"Function : (\S+)", sass)
    bodies = dict(zip(parts[1::2], parts[2::2]))
    mma = re.compile(r"\b(" + "|".join(MMA_SASS) + r")\b")
    counts = {name: len(mma.findall(body)) for name, body in bodies.items()}
    for kernel in LOGIC_ONLY + CUDA_CORE:
        mine = [name for name in bodies if kernel in name]
        check(bool(mine), f"no SASS for {kernel} in {lib_path.name}")
        for name in mine:
            check(re.search(r"\b(IMAD|FFMA)", bodies[name]) is not None,
                  f"{name}: no multiply-add in its SASS")
            check(counts[name] == 0, f"{name}: {counts[name]} MMA "
                                     f"instructions in a CUDA-core kernel")
    tc_sass = {k: v for kernels in TC_SASS.values() for k, v in kernels.items()}
    for kernel, want in tc_sass.items():
        mine = [name for name in bodies if kernel in name]
        check(bool(mine), f"no SASS for {kernel} in {lib_path.name}")
        for name in mine:
            kinds = {k: len(re.findall(rf"\b{k}\b", bodies[name]))
                     for k in MMA_SASS}
            check(kinds[want] > 0 and counts[name] == kinds[want],
                  f"{name}: MMA instructions {kinds}, expected {want} only")
    for row, names in KERNEL.items():
        for kernel in names.split(", "):
            check(any(kernel in name for name in bodies),
                  f"{row}: no SASS for {kernel} in {lib_path.name}")
    for kernel in WIDE_SASS:
        check(any(kernel in name for name in bodies),
              f"no SASS for {kernel} in {lib_path.name}")
    log(f"SASS: {len(bodies)} kernels; no {'|'.join(MMA_SASS)} in "
        f"{', '.join(LOGIC_ONLY + CUDA_CORE)}; "
        + ", ".join(f"{k}: {v} x"
                    f"{sum(n for name, n in counts.items() if k in name)}"
                    for k, v in tc_sass.items())
        + f"; MMA in any kernel: {sum(counts.values())}")
    return counts


# ---------------------------------------------------------------------------
# Phase 5: times
# ---------------------------------------------------------------------------
def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(peaks, n_bytes, ops, rate="fp32_flops"):
    """The least time (ms) the card could take: the larger of ``n_bytes``
    over the memory rate and ``ops`` over the peak ``rate``; and which of
    the two it is."""
    t_bytes = n_bytes / peaks["bytes_per_s"] * 1e3
    t_ops = ops / peaks[rate] * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps=REPS, warmup=3):
    """Median device time (ms) of one call of ``fn`` over ``reps`` calls.

    The calls are queued behind a sleep kernel, each between two CUDA
    events, so the host's time to issue them (the Python wrapper, its
    checks, the ctypes call) falls outside the timed intervals: an idle
    device would otherwise wait for the host inside the interval.  The
    sleep is doubled until it outlasts the host's enqueueing."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(8):
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(reps + 2)]
        events[0].record()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        for i in range(1, reps + 1):
            events[i].record()
            fn()
        events[reps + 1].record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if events[0].elapsed_time(events[1]) > enqueue_ms:
            return statistics.median(events[i].elapsed_time(events[i + 1])
                                     for i in range(1, reps + 1))
        cycles *= 2
    raise SmokeFailure("the host could not queue the timed calls ahead "
                       "of the device")


def res_usage(lib_path):
    """``cuobjdump -res-usage`` of the built library: registers a thread
    by (mangled) kernel name."""
    import re
    from repro_torch.kernels import cuda
    tool = Path(cuda._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-res-usage", str(lib_path)],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"Function (\S+):\s*REG:(\d+)", out)}


def grid_note(lib_path, mangled, ctas, smem):
    """The grid of a tiled launch of 256-thread CTAs: the CTAs, the
    kernel's registers (``res_usage``, the instantiation whose mangled
    name starts with ``mangled``), the CTAs an SM that registers, shared
    memory (``smem`` bytes dynamic, 1 KB reserved a CTA, 228 KB an SM)
    and threads allow, and the waves on the card's SMs."""
    import torch
    regs = [r for name, r in res_usage(lib_path).items()
            if name.startswith(mangled)]
    check(len(regs) == 1, f"no single kernel {mangled} in the library")
    per_sm = min(65536 // (-(-regs[0] // 8) * 8 * 256),
                 (228 * 1024) // (smem + 1024), 2048 // 256)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (f"grid {ctas} CTAs, {regs[0]} registers, {smem} B shared, "
            f"{per_sm} CTAs an SM, {ctas / (per_sm * sms):.2f} waves on "
            f"{sms} SMs")


# template arguments of the CNN kernels in their mangled names
MANGLED_T = {"torch.float32": "f", "torch.bfloat16": "13__nv_bfloat16",
             "torch.int8": "a", "torch.int16": "s"}


def fused_grid(lib_path, style, x, w):
    """grid_note of a fused_cnn_vpu / fused_cnn_mxu call at its default
    2x2 pool."""
    from repro_torch.kernels.conv2d.inner import (STYLE_CODE,
                                                  fused_plan,
                                                  fused_smem_bytes)
    n, h, w_, cin = x.shape
    kh, kw, _, cout = w.shape
    plan = fused_plan(h, w_, cin, kh, kw, cout, 2, 2, 2, 2,
                      itemsize=x.element_size(), style=style)
    po, qo = (h - kh + 1 - 2) // 2 + 1, (w_ - kw + 1 - 2) // 2 + 1
    ctas = (n * -(-po // plan.tp) * -(-qo // plan.tq)
            * -(-cout // plan.tile.bc))
    ks = 3 if (kh, kw) == (3, 3) and plan.tile.whole else 0
    mangled = (f"_ZN3cnn22fused_cnn_tiled_kernelI{MANGLED_T[str(x.dtype)]}"
               f"Li{STYLE_CODE[style]}ELi{ks}ELb{int(plan.tile.whole)}E")
    return grid_note(lib_path, mangled, ctas, fused_smem_bytes(
        plan, kh, kw, cin, itemsize=x.element_size(), style=style))


def conv3_grid(lib_path, x, w):
    """grid_note of a conv2d_ip3 call."""
    from repro_torch.kernels.conv2d.inner import tile_plan, tile_smem_bytes
    n, h, w_, cin = x.shape
    kh, kw, _, cout = w.shape
    plan = tile_plan(h, w_, cin, kh, kw, cout, itemsize=1, style="packed")
    ho, wo = h - kh + 1, w_ - kw + 1
    ctas = n * -(-ho // plan.th) * -(-wo // plan.tw) * -(-cout // plan.bc)
    ks = 3 if (kh, kw) == (3, 3) and plan.whole else 0
    mangled = (f"_ZN3cnn23conv2d_ip3_tiled_kernelILi{ks}ELb{int(plan.whole)}"
               f"EE")
    return grid_note(lib_path, mangled, ctas, tile_smem_bytes(
        plan, kh, kw, cin, itemsize=1, style="packed"))


def timings(shapes, gen, peaks, lib):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.activation.vpu_exact import (
        activation_exact, activation_exact_plain)
    from repro_torch.kernels.conv2d.ip1_vpu import conv2d_ip1, conv2d_ip1_plain
    from repro_torch.kernels.conv2d.ip2_mxu import conv2d_ip2, conv2d_ip2_plain
    from repro_torch.kernels.fused.cnn_block import (fused_cnn_mxu,
                                                     fused_cnn_plain,
                                                     fused_cnn_vpu)
    from repro_torch.kernels.pool2d.vpu_window import (pool2d_window,
                                                       pool2d_window_plain)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def bound(n_bytes, flops, rate="fp32_flops"):
        return bound_ms(peaks, n_bytes, flops, rate)

    rows = {}
    (x0s, w0s), (x1s, w1s) = shapes["block0"], shapes["block1"]
    x0, w0 = torch.randn(x0s, generator=gen).to(dev), \
        torch.randn(w0s, generator=gen).to(dev)
    x1, w1 = torch.randn(x1s, generator=gen).to(dev), \
        torch.randn(w1s, generator=gen).to(dev)

    def conv_lib(x, w):
        return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))

    # plain versions that launch a step a channel of K (the Conv2 chain)
    # are timed call by call: the host cannot queue 20 of them ahead
    for name, kern, plain, x, w, plain_time in (
            ("conv2d_ip1", conv2d_ip1, conv2d_ip1_plain, x0, w0, time_ms),
            ("conv2d_ip2", conv2d_ip2, conv2d_ip2_plain, x1, w1,
             time_sync_ms)):
        y = kern(x, w)
        k = w.shape[0] * w.shape[1] * w.shape[2]
        b_ms, by = bound(nbytes(x, w, y), 2 * k * y.numel())
        rows[name] = dict(ms=time_ms(lambda: kern(x, w)),
                          plain_ms=plain_time(lambda: plain(x, w)),
                          library_ms=time_ms(lambda: conv_lib(x, w)),
                          bound_ms=b_ms, bound_by=by,
                          shape=f"x{tuple(x.shape)} w{tuple(w.shape)}")
    # the tiled Conv1 at block 1 (f32) and on int8 at block 0, the tiled
    # Conv2 on int8 at block 1 (int32 multiply-adds on the INT32 lanes;
    # no PyTorch int8 conv on CUDA)
    xi0, wi0 = operand(gen, x0s, torch.int8), operand(gen, w0s, torch.int8)
    xi1, wi1 = operand(gen, x1s, torch.int8), operand(gen, w1s, torch.int8)
    for name, kern, plain, x, w, rate, lib_fn in (
            ("conv2d_ip1 (f32, block 1)", conv2d_ip1, conv2d_ip1_plain, x1,
             w1, "fp32_flops", lambda: conv_lib(x1, w1)),
            ("conv2d_ip1 (int8, block 0)", conv2d_ip1, conv2d_ip1_plain,
             xi0, wi0, "int32_ops", None),
            ("conv2d_ip2 (int8, block 1)", conv2d_ip2, conv2d_ip2_plain,
             xi1, wi1, "int32_ops", None)):
        y = kern(x, w)
        k = w.shape[0] * w.shape[1] * w.shape[2]
        b_ms, by = bound(nbytes(x, w, y), 2 * k * y.numel(), rate)
        rows[name] = dict(
            ms=time_ms(lambda: kern(x, w)),
            plain_ms=time_sync_ms(lambda: plain(x, w)),
            library_ms=None if lib_fn is None else time_ms(lib_fn),
            bound_ms=b_ms, bound_by=by,
            shape=f"x{tuple(x.shape)} w{tuple(w.shape)} {x.dtype}")

    y0 = conv2d_ip1(x0, w0)
    p0 = pool2d_window(y0)
    b_ms, by = bound(nbytes(y0, p0), 4 * p0.numel())
    rows["pool2d_window"] = dict(
        ms=time_ms(lambda: pool2d_window(y0)),
        plain_ms=time_ms(lambda: pool2d_window_plain(y0)),
        library_ms=time_ms(lambda: F.max_pool2d(y0.permute(0, 3, 1, 2), 2)),
        bound_ms=b_ms, bound_by=by, shape=f"x{tuple(y0.shape)} max 2x2")
    # beside the served row: a batch-64 block 0, beyond the 50 MB L2, and
    # the overlapping 3x3 / 1 and 3x3 / 2 windows at the served shape
    # (their overlap served by L1 and L2; bound: each input read once)
    big = torch.Generator().manual_seed(SEED)
    xl = torch.randn((64, 222, 222, 16), generator=big).to(dev)
    for name, x, window, stride in (
            ("pool2d_window (large)", xl, (2, 2), (2, 2)),
            ("pool2d_window (3x3 s1)", y0, (3, 3), (1, 1)),
            ("pool2d_window (3x3 s2)", y0, (3, 3), (2, 2))):
        y = pool2d_window(x, window=window, stride=stride)
        b_ms, by = bound(nbytes(x, y), window[0] * window[1] * y.numel())
        rows[name] = dict(
            ms=time_ms(lambda: pool2d_window(x, window=window,
                                             stride=stride)),
            plain_ms=time_ms(lambda: pool2d_window_plain(
                x, window=window, stride=stride)),
            library_ms=time_ms(lambda: F.max_pool2d(
                x.permute(0, 3, 1, 2), window, stride)),
            bound_ms=b_ms, bound_by=by,
            shape=f"x{tuple(x.shape)} max {window[0]}x{window[1]} stride "
                  f"{stride}")
    del y
    a0 = activation_exact(p0)
    b_ms, by = bound(nbytes(p0, a0), p0.numel())
    rows["activation_exact"] = dict(
        ms=time_ms(lambda: activation_exact(p0)),
        plain_ms=time_ms(lambda: activation_exact_plain(p0)),
        library_ms=time_ms(lambda: torch.relu(p0)),
        bound_ms=b_ms, bound_by=by, shape=f"x{tuple(p0.shape)} relu")

    conv_of = {"vpu": conv2d_ip1, "mxu": conv2d_ip2}

    def chain_yardstick(style, x, w):
        conv = conv_of[style]
        return (f"the three-launch chain ({conv.__name__}, pool2d_window, "
                f"activation_exact)", time_ms(
                    lambda: activation_exact(pool2d_window(conv(x, w)))))

    for name, style, kern, x, w in (("fused_cnn_vpu", "vpu", fused_cnn_vpu,
                                     x0, w0),
                                    ("fused_cnn_mxu", "mxu", fused_cnn_mxu,
                                     x1, w1)):
        y = kern(x, w)
        k = w.shape[0] * w.shape[1] * w.shape[2]
        # the conv values the pooled outputs need: 4 per output (2x2)
        flops = 4 * y.numel() * (2 * k + 1) + y.numel()
        b_ms, by = bound(nbytes(x, w, y), flops)
        rows[name] = dict(
            ms=time_ms(lambda: kern(x, w)),
            plain_ms=(time_ms if style == "vpu" else time_sync_ms)(
                lambda: fused_cnn_plain(style, x, w)),
            library_ms=None, bound_ms=b_ms, bound_by=by,
            shape=f"x{tuple(x.shape)} w{tuple(w.shape)} max 2x2 relu",
            yardstick=chain_yardstick(style, x, w),
            grid=fused_grid(lib, style, x, w))
    # the bf16 tenant's kernels (PR 21): both fused blocks and Conv2 at
    # block 1, beside bf16 F.conv2d (cuDNN, on the tensor cores)
    bf = torch.bfloat16
    for name, style, kern, x, w in (
            ("fused_cnn_vpu (bf16, block 0)", "vpu", fused_cnn_vpu, x0, w0),
            ("fused_cnn_mxu (bf16, block 1)", "mxu", fused_cnn_mxu, x1, w1)):
        xb, wb = x.to(bf), w.to(bf)
        y = kern(xb, wb)
        k = w.shape[0] * w.shape[1] * w.shape[2]
        # the MXU style at the card's bf16 tensor-core rate (as bf16
        # mm_mxu), the logic-only style at its FP32 rate
        b_ms, by = bound(nbytes(xb, wb, y), 4 * y.numel() * (2 * k + 1)
                         + y.numel(),
                         "fp32_flops" if style == "vpu" else
                         "bf16_tensor_flops")
        rows[name] = dict(
            ms=time_ms(lambda: kern(xb, wb)),
            plain_ms=(time_ms if style == "vpu" else time_sync_ms)(
                lambda: fused_cnn_plain(style, xb, wb)),
            library_ms=None, bound_ms=b_ms, bound_by=by,
            shape=f"x{tuple(x.shape)} w{tuple(w.shape)} bf16 max 2x2 relu",
            yardstick=chain_yardstick(style, xb, wb),
            grid=fused_grid(lib, style, xb, wb))
    xb1, wb1 = x1.to(bf), w1.to(bf)
    y = conv2d_ip2(xb1, wb1)
    k = w1.shape[0] * w1.shape[1] * w1.shape[2]
    b_ms, by = bound(nbytes(xb1, wb1, y), 2 * k * y.numel(),
                     "bf16_tensor_flops")
    rows["conv2d_ip2 (bf16, block 1)"] = dict(
        ms=time_ms(lambda: conv2d_ip2(xb1, wb1)),
        plain_ms=time_sync_ms(lambda: conv2d_ip2_plain(xb1, wb1)),
        library_ms=time_ms(lambda: conv_lib(xb1, wb1)), bound_ms=b_ms,
        bound_by=by, shape=f"x{tuple(x1.shape)} w{tuple(w1.shape)} bf16",
        library="bf16 F.conv2d, tensor cores, bf16 out")
    # the precision ladder's kernels: Act2 at its served shape, Pool2 at
    # the pool2d(budget=) shape
    from repro_torch.kernels.activation.lut_poly import (
        activation_lut, activation_lut_plain)
    from repro_torch.kernels.pool2d.mxu_im2col import (pool2d_im2col,
                                                       pool2d_im2col_plain)
    xa = torch.randn((4, 54, 54, 32), generator=gen).to(dev) * 2
    ya = activation_lut(xa, kind="tanh")
    b_ms, by = bound(nbytes(xa, ya) + 256 * 4, 4 * xa.numel())
    rows["activation_lut"] = dict(
        ms=time_ms(lambda: activation_lut(xa, kind="tanh")),
        plain_ms=time_ms(lambda: activation_lut_plain(xa, kind="tanh")),
        library_ms=None, bound_ms=b_ms, bound_by=by,
        shape=f"x{tuple(xa.shape)} tanh",
        yardstick=("torch.tanh (the exact function)",
                   time_ms(lambda: torch.tanh(xa))))
    # beside the served row: 256 images of the served block (95.6 MB in,
    # as much out)
    xal = torch.randn((256, 54, 54, 32), generator=big).to(dev) * 2
    yal = activation_lut(xal, kind="tanh")
    check(torch.equal(yal, activation_lut_plain(xal, kind="tanh")),
          "activation_lut (large): not bitwise equal to the plain version")
    b_ms, by = bound(nbytes(xal, yal) + 256 * 4, 4 * xal.numel())
    rows["activation_lut (large)"] = dict(
        ms=time_ms(lambda: activation_lut(xal, kind="tanh")),
        plain_ms=time_ms(lambda: activation_lut_plain(xal, kind="tanh")),
        library_ms=None, bound_ms=b_ms, bound_by=by,
        shape=f"x{tuple(xal.shape)} tanh",
        yardstick=("torch.tanh (the exact function)",
                   time_ms(lambda: torch.tanh(xal))))
    del xal, yal
    # Pool2 at the pool2d(budget=) shape and, beside it, on pool2d_window's
    # large input (64,222,222,16), beyond the 50 MB L2
    xp = torch.randn((4, 222, 222, 16), generator=gen).to(dev)
    for name, x in (("pool2d_im2col", xp), ("pool2d_im2col (large)", xl)):
        y = pool2d_im2col(x, mode="avg")
        check(torch.equal(y, pool2d_window(x, mode="avg")),
              f"{name}: not bitwise pool2d_window")
        b_ms, by = bound(nbytes(x, y), 4 * y.numel())
        rows[name] = dict(
            ms=time_ms(lambda: pool2d_im2col(x, mode="avg")),
            plain_ms=time_ms(lambda: pool2d_im2col_plain(x, mode="avg")),
            library_ms=time_ms(lambda: F.avg_pool2d(x.permute(0, 3, 1, 2),
                                                    2)),
            bound_ms=b_ms, bound_by=by, shape=f"x{tuple(x.shape)} avg 2x2")
    del xl, y

    # the dual-stream convs at block 1: Conv3 on full-range int8 (INT32
    # lanes), Conv4 on f32; two multiply-adds per tap per stream
    from repro_torch.kernels.conv2d.ip3_packed import (conv2d_ip3,
                                                       conv2d_ip3_plain)
    from repro_torch.kernels.conv2d.ip4_dual import (conv2d_ip4,
                                                     conv2d_ip4_plain)
    k1 = w1s[0] * w1s[1] * w1s[2]
    ia, ib, iw = (operand(gen, s_, torch.int8) for s_ in (x1s, x1s, w1s))
    ya, yb = conv2d_ip3(ia, ib, iw)
    b_ms, by = bound(nbytes(ia, ib, iw, ya, yb), 2 * 2 * k1 * ya.numel(),
                     "int32_ops")
    rows["conv2d_ip3"] = dict(
        ms=time_ms(lambda: conv2d_ip3(ia, ib, iw)),
        plain_ms=time_ms(lambda: conv2d_ip3_plain(ia, ib, iw)),
        library_ms=None, bound_ms=b_ms, bound_by=by,
        shape=f"2 x{tuple(ia.shape)} int8 w{tuple(iw.shape)}",
        yardstick=("two conv2d_ip1 launches (no PyTorch int8 conv on CUDA)",
                   time_ms(lambda: (conv2d_ip1(ia, iw), conv2d_ip1(ib, iw)))),
        yardstick2=("two int8 conv2d_ip2 launches",
                    time_ms(lambda: (conv2d_ip2(ia, iw), conv2d_ip2(ib, iw)))),
        grid=conv3_grid(lib, ia, iw))
    fa, fb = operand(gen, x1s, torch.float32), operand(gen, x1s,
                                                       torch.float32)
    fw = operand(gen, w1s, torch.float32, k1 ** -0.5)
    ya, yb = conv2d_ip4(fa, fb, fw)
    b_ms, by = bound(nbytes(fa, fb, fw, ya, yb), 2 * 2 * k1 * ya.numel())
    rows["conv2d_ip4"] = dict(
        ms=time_ms(lambda: conv2d_ip4(fa, fb, fw)),
        plain_ms=time_sync_ms(lambda: conv2d_ip4_plain(fa, fb, fw)),
        library_ms=time_ms(lambda: (conv_lib(fa, fw), conv_lib(fb, fw))),
        bound_ms=b_ms, bound_by=by,
        shape=f"2 x{tuple(fa.shape)} f32 w{tuple(fw.shape)}",
        yardstick=("two conv2d_ip2 launches",
                   time_ms(lambda: (conv2d_ip2(fa, fw), conv2d_ip2(fb, fw)))))

    # the matmuls at FFN: f32 (FP32 rate), int8 and bf16 (their
    # tensor-core peaks)
    from repro_torch.kernels.matmul.mxu import (mm_mxu, mm_mxu_plain,
                                                mm_vpu, mm_vpu_plain)
    m, k, n = FFN
    a, b = operand(gen, (m, k), torch.float32), operand(gen, (k, n),
                                                        torch.float32)
    a8, b8 = operand(gen, (m, k), torch.int8), operand(gen, (k, n),
                                                       torch.int8)

    try:
        torch._int_mm(a8, b8)
        b8_lib, layout = b8, "row-major"
    except RuntimeError:             # cuBLASLt may want b column-major
        b8_lib, layout = b8.t().contiguous().t(), "column-major"

    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    for name, kern, plain, x, y, rate, lib_fn in (
            ("mm_mxu", mm_mxu, mm_mxu_plain, a, b, "fp32_flops",
             lambda: torch.matmul(a, b)),
            ("mm_mxu (int8)", mm_mxu, mm_mxu_plain, a8, b8,
             "int8_tensor_ops", lambda: torch._int_mm(a8, b8_lib)),
            ("mm_mxu (bf16)", mm_mxu, mm_mxu_plain, a16, b16,
             "bf16_tensor_flops", lambda: torch.matmul(a16, b16)),
            ("mm_vpu", mm_vpu, mm_vpu_plain, a, b, "fp32_flops",
             lambda: torch.matmul(a, b)),
            # logic-only: the library calls below use the tensor cores,
            # which mm_vpu's contract bars
            ("mm_vpu (int8)", mm_vpu, mm_vpu_plain, a8, b8, "int32_ops",
             lambda: torch._int_mm(a8, b8_lib)),
            ("mm_vpu (bf16)", mm_vpu, mm_vpu_plain, a16, b16, "fp32_flops",
             lambda: torch.matmul(a16, b16))):
        out = kern(x, y)
        b_ms, by = bound(nbytes(x, y, out), 2 * m * k * n, rate)
        rows[name] = dict(
            ms=time_ms(lambda: kern(x, y)),
            plain_ms=time_ms(lambda: plain(x, y)),
            library_ms=time_ms(lib_fn), bound_ms=b_ms, bound_by=by,
            shape=f"({m}, {k}) x ({k}, {n}) {x.dtype}"
            + (f"; torch._int_mm on {layout} b" if name.endswith("(int8)")
               else ""))
    return rows


def ladder_window(srv, trace, rounds):
    """Wall seconds (host clock, synchronized at both ends) of ``rounds``
    rounds of a ladder trace: each wave submitted, then ``step()``."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        for wave in trace:
            for tenant, x in wave:
                srv.submit(tenant, x)
            srv.step()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def ladder_rate(name, trace, calibration=None):
    """A LADDER deployment's served rate: after a warm-up round, windows
    of rounds of its trace sized to about 1.25 * RATE_WINDOW_S, timed
    RATE_WINDOWS times.  Returns (requests per window, walls)."""
    srv = ladder_server(name, "cuda", calibration)
    ladder_window(srv, trace, 1)
    wall = ladder_window(srv, trace, 1)
    rounds = max(1, math.ceil(1.25 * RATE_WINDOW_S / wall))
    while True:
        walls = [ladder_window(srv, trace, rounds)
                 for _ in range(RATE_WINDOWS)]
        if min(walls) >= RATE_WINDOW_S:
            return rounds * sum(len(w) for w in trace), walls
        rounds *= 2


def serve_window(srv, requests, rounds):
    """Wall seconds (host clock, synchronized at both ends) of ``rounds``
    rounds of the trace: submit every request, then ``drain()``."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        for x in requests:
            srv.submit("cnn", x)
        srv.drain()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def served_rate(requests):
    """The fused server's steady-state rate.  After a warm-up round, a
    window is sized to at least RATE_MIN_REQUESTS requests and about
    RATE_WINDOW_S seconds, and RATE_WINDOWS such windows are timed.
    Returns the server, the rounds per window and the windows' walls."""
    from repro_torch.models.frontends import init_cnn_frontend
    from repro_torch.runtime.server import AdaptiveServer
    srv = AdaptiveServer(max_batch=MAX_BATCH)
    srv.register("cnn", init_cnn_frontend(SEED), IMAGE)
    serve_window(srv, requests, 1)                  # warms plans
    rounds = -(-RATE_MIN_REQUESTS // len(requests))
    wall = serve_window(srv, requests, rounds)
    rounds = max(rounds, math.ceil(rounds * 1.25 * RATE_WINDOW_S / wall))
    walls = [serve_window(srv, requests, rounds)
             for _ in range(RATE_WINDOWS)]
    return srv, rounds, walls


def profile_serving(srv, requests, rounds, wall_s):
    """One more window of ``rounds`` rounds under ``torch.profiler``:
    device time by kernel, and the device's busy share of ``wall_s``, the
    median un-profiled wall of a window of the same requests."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = serve_window(srv, requests, rounds)
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
        # aten:: rows repeat their kernels' device time; the activity
        # buffer row is the profiler's own
        if dev > 0 and not ev.key.startswith(("aten::", "Activity")):
            rows.append((dev, ev.key, ev.count))
    busy = sum(r[0] for r in rows)
    check(busy > 0, "the profiler saw no device time")
    n = rounds * len(requests)
    for dev, key, count in sorted(rows, reverse=True)[:8]:
        log(f"profile: {dev:10.1f} us device x{count:<5d} "
            f"({dev / n:.2f} us per request) {key[:60]}")
    wall_us = wall_s * 1e6
    log(f"profile: {n} requests, device busy {busy:.1f} us; busy share "
        f"{busy / wall_us:.4f} of the un-profiled window ({wall_us:.1f} "
        f"us), {busy / (prof_wall * 1e6):.4f} of the profiled one "
        f"({prof_wall * 1e6:.1f} us)")


# ---------------------------------------------------------------------------
# "lm serve": the hybrid LM served through the selective-scan kernel
# ---------------------------------------------------------------------------
def jamba_period(**dtypes):
    """``JAMBA`` at full width with depth and MoE cut: one period of the
    stack (1 attention + 7 Mamba layers), dense FFNs; ``dtypes`` replace
    the config's own (bf16 params and compute, bf16 logits)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(JAMBA), n_layers=8, moe=None,
                               **dtypes)


def lm_trace(cfg, spec=LM_TRACE):
    import numpy as np
    from repro_torch.launch.serve import make_requests
    return make_requests(cfg, spec["requests"], spec["prompt_len"],
                         spec["max_new"], np.random.default_rng(SEED))


def serve_lm_trace(cfg, params, spec=LM_TRACE):
    """Serve an LM trace (``spec``: slots, requests, prompt_len, max_new,
    max_len) once with the counters reset just before and read just
    after: (token lists by request id, counts, stats)."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.launch.serve import serve_requests
    torch.cuda.synchronize()
    cuda.reset_launches()
    done, stats = serve_requests(cfg, params, lm_trace(cfg, spec),
                                 slots=spec["slots"],
                                 max_len=spec["max_len"], device="cuda")
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    return {r.rid: r.generated for r in done}, counts, stats


def first_mamba_operands(cfg, params, prompt):
    """The scan operands of the stack's first Mamba layer (sub1 of group
    0) on ``prompt``: the attention layer sub0 runs first, then sub1's
    norm, as the prefill runs them."""
    import torch
    from repro_torch.models import mamba, transformer
    from repro_torch.models.blocks import apply_norm
    batch = {"tokens": torch.as_tensor(prompt[None, :], device="cuda")}
    x, positions = transformer._embed_inputs(cfg, params, batch)
    gp = transformer._group(params["blocks"], 0)
    check(transformer.period_pattern(cfg)[:2] == [("attn", False),
                                                  ("mamba", False)],
          "the period does not start with attention, then Mamba")
    x, _, _ = transformer._apply_sub(cfg, gp["sub0"], x, positions, "attn",
                                     False, False)
    h = apply_norm(cfg, gp["sub1"]["ln1"], x)
    return mamba.scan_operands(cfg, gp["sub1"]["mamba"], h)


def scan_data(rng, b, t, di, ds):
    """The reference test's distribution (``_data`` of
    tests/test_kernels_mamba_scan.py), numpy-seeded, on the card."""
    import numpy as np
    import torch
    f = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
    return (f(rng.normal(size=(b, t, di))),
            f(0.1 * np.abs(rng.normal(size=(b, t, di)))),
            f(rng.normal(size=(b, t, ds))), f(rng.normal(size=(b, t, ds))),
            f(-np.abs(rng.normal(size=(di, ds)))))


def scan_f64(x, dt, bp, cp, a):
    """The scan's recurrence in f64 (the oracle's steps on f64 operands):
    the witness the kernel's and the oracle's f32 y are measured
    against."""
    import torch
    x, dt, bp, cp, a = (v.double() for v in (x, dt, bp, cp, a))
    h = torch.zeros((x.shape[0], x.shape[2], a.shape[1]),
                    dtype=torch.float64, device=x.device)
    ys = []
    for i in range(x.shape[1]):
        d = dt[:, i]
        h = (torch.exp(d[..., None] * a[None]) * h
             + (d * x[:, i])[..., None] * bp[:, i, None, :])
        ys.append((h * cp[:, i, None, :]).sum(-1))
    return torch.stack(ys, 1)


def compare_scan(what, ops, tol, errs, witness=False):
    """``selective_scan`` (one launch) bitwise equal to its plain version
    (the kernel's y-sum order), and y and the final h within ``tol`` of
    the family oracle ``selective_scan_ref`` (torch's own sum over the
    states; ``atol=None``: 1e-4 of each output's RMS); results must not
    depend on ``block_di``.  With ``witness``, the kernel's and the
    oracle's y are also measured against the recurrence in f64
    (``scan_f64``) and both max abs errors logged."""
    import torch
    from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
    from repro_torch.kernels.mamba_scan.scan import (selective_scan,
                                                     selective_scan_plain)
    got = launched_once(lambda: selective_scan(*ops), "selective_scan",
                        what)
    di = ops[0].shape[2]
    for bdi in (64, di):
        alt = selective_scan(*ops, block_di=bdi)
        check(all(torch.equal(a, g) for a, g in zip(alt, got)),
              f"selective_scan {what}: block_di={bdi} changes the result")
    for g, w in zip(got, selective_scan_plain(*ops)):
        compare("selective_scan", g, w, 0, 0, errs, exact=True)
    notes = []
    oracle = selective_scan_ref(*ops)
    for name, g, w in zip(("y", "h"), got, oracle):
        rms = float(w.double().pow(2).mean().sqrt())
        atol = tol["atol"] if tol["atol"] is not None else 1e-4 * rms
        check(bool(torch.isfinite(g).all()),
              f"selective_scan {what}: non-finite {name}")
        torch.testing.assert_close(
            g, w, rtol=tol["rtol"], atol=atol,
            msg=lambda m: f"selective_scan {what}, {name} against the "
                          f"oracle: {m}")
        err = float((g.double() - w.double()).abs().max())
        notes.append(f"{name}: RMS {rms:.4e}, atol {atol:.3e}, max abs err "
                     f"{err:.3e}, "
                     f"{'bitwise' if torch.equal(g, w) else 'not bitwise'}")
    if witness:
        y64 = scan_f64(*ops)
        e64 = [float((v.double() - y64).abs().max())
               for v in (got[0], oracle[0])]
        notes.append(f"y's max abs err against the f64 recurrence: kernel "
                     f"{e64[0]:.4e}, oracle {e64[1]:.4e}")
    log(f"selective_scan {what}: one launch, bitwise equal to the plain "
        f"version, within rtol={tol['rtol']} of the oracle "
        f"selective_scan_ref ({'; '.join(notes)}); block_di 64, 256 and "
        f"{di} bitwise equal")
    return got


def scan_checks(ops, rng, errs):
    """Check 2 (kernel against plain version) and check 5 (the library
    entry): the model's own operands, the reference test's distribution
    at full width, small cases, and the d_states of SCAN_DS_CASES."""
    import torch
    from repro_torch.core.library import get_family
    from repro_torch.kernels import cuda
    from repro_torch.kernels.mamba_scan.scan import lane_plan
    compare_scan(f"at the first Mamba layer's operands {SCAN_SITE}", ops,
                 dict(rtol=1e-5, atol=None), errs, witness=True)
    for case in SCAN_FULL_CASES + SCAN_SMALL_CASES:
        compare_scan(f"on the reference test's data {case}",
                     scan_data(rng, *case), SCAN_TOL, errs,
                     witness=case in SCAN_FULL_CASES)
    sms = cuda.sm_count(torch.device("cuda"))
    for case in SCAN_DS_CASES:
        compare_scan(f"at d_state {case[3]} {case} (plan "
                     f"{tuple(lane_plan(case[0], case[2], case[3], sms))})",
                     scan_data(rng, *case), SCAN_TOL, errs,
                     witness=case[2] >= 16384)
    member = get_family("ssm_scan")["ssm_scan.selective_vmem"]
    small = scan_data(rng, 2, 16, 32, 8)
    launched_once(lambda: member(*small), "selective_scan",
                  "get_family('ssm_scan')['ssm_scan.selective_vmem']")
    cuda.reset_launches()
    member(*(t.cpu() for t in small))
    check(cuda.launch_counts() == {}, "the library entry launched on CPU "
                                      "tensors")
    log("library entry ssm_scan.selective_vmem: one launch on CUDA "
        "tensors, none on CPU tensors")
    torch.cuda.synchronize()


def seq_vs_step_check(gen):
    """Check 3: one full-width Mamba layer in f32, the prefill (the
    kernel) against 64 decode steps."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.models import mamba
    cfg = jamba_period(param_dtype="float32", compute_dtype="float32")
    p = mamba.init_mamba(cfg, gen, device="cuda")
    x = torch.randn((1, SEQ_STEPS, cfg.d_model), generator=gen,
                    device="cuda")
    cuda.reset_launches()
    y_seq, c_seq = mamba.mamba_forward_with_cache(cfg, p, x)
    torch.cuda.synchronize()
    check(cuda.launch_counts() == {"selective_scan": 1},
          f"the f32 Mamba prefill launched {cuda.launch_counts()}")
    cache = mamba.init_mamba_cache(cfg, 1, dtype=torch.float32,
                                   device="cuda")
    ys = []
    for t in range(SEQ_STEPS):
        y_t, cache = mamba.mamba_step(cfg, p, x[:, t:t + 1], cache)
        ys.append(y_t)
    y_step = torch.cat(ys, dim=1)
    notes = []
    for name, got, want in (("out", y_seq, y_step),
                            ("ssm", c_seq["ssm"], cache["ssm"]),
                            ("conv", c_seq["conv"], cache["conv"])):
        rms = float(want.double().pow(2).mean().sqrt())
        atol = min(SEQ_TOL["atol"], 1e-4 * rms)
        torch.testing.assert_close(got, want, rtol=SEQ_TOL["rtol"],
                                   atol=atol,
                                   msg=lambda m: f"seq vs step {name}: {m}")
        err = float((got.double() - want.double()).abs().max())
        notes.append(f"{name} RMS {rms:.4e}, atol {atol:.3e}, max abs err "
                     f"{err:.3e}")
    log(f"f32 Mamba layer at full width: prefill over {SEQ_STEPS} tokens "
        f"(one selective_scan launch) equals {SEQ_STEPS} decode steps within "
        f"rtol={SEQ_TOL['rtol']} ({'; '.join(notes)})")


def handoff_errors(cfg, params, requests):
    """Check 4's reading: for each request, the first decode step's
    logits after prefilling its prompt against the last-position logits
    of a prefill over the prompt plus that token.  Returns (relative L2
    errors, argmax agreements)."""
    import torch
    from repro_torch.models import api
    errs, same = [], []
    for req in requests:
        tokens = torch.as_tensor(req.prompt[None, :], device="cuda")
        s = tokens.shape[1]
        logits, caches, _ = api.prefill_step(cfg, params,
                                             {"tokens": tokens},
                                             pad_to=s + 1)
        tok = torch.argmax(logits, dim=-1, keepdim=True)
        dec, _ = api.decode_step(cfg, params, caches, tok, s)
        full, _, _ = api.prefill_step(
            cfg, params, {"tokens": torch.cat([tokens, tok], dim=1)})
        d, f = dec.double(), full.double()
        errs.append(float((d - f).norm() / f.norm()))
        same.append(bool(torch.equal(dec.argmax(-1), full.argmax(-1))))
        del caches
    return errs, same


def profile_lm(cfg, params, prompt, caches, tick_tokens, tick_pos):
    """One prefill and one decode tick under ``torch.profiler``: device
    time by kernel (top rows) and the selective scan's share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import api
    batch = {"tokens": torch.as_tensor(prompt[None, :], device="cuda")}
    out = {}
    for name, fn in (
            ("prefill", lambda: api.prefill_step(
                cfg, params, batch, pad_to=LM_TRACE["max_len"])),
            ("decode tick", lambda: api.decode_step(
                cfg, params, caches, tick_tokens, tick_pos))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = []
        for ev in prof.key_averages():
            dev = getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0.0))
            if dev > 0 and not ev.key.startswith(("aten::", "Activity")):
                rows.append((dev, ev.key, ev.count))
        busy = sum(r[0] for r in rows)
        check(busy > 0, f"the profiler saw no device time in the {name}")
        scan = sum(r[0] for r in rows if "selective_scan_kernel" in r[1])
        for dev, key, count in sorted(rows, reverse=True)[:8]:
            log(f"lm profile {name}: {dev:10.1f} us device x{count:<4d} "
                f"({dev / busy:.4f}) {key[:70]}")
        log(f"lm profile {name}: device busy {busy:.1f} us, "
            f"selective_scan_kernel {scan:.1f} us ({scan / busy:.4f})")
        out[name] = (busy, scan)
    return out


def lm_serve_phase(peaks, card, errs):
    """The fifth slice's path: ``jamba_period`` in bf16 serves the LM
    trace through ``launch/serve.py``'s loop (checks 1-5, times,
    profile), then the f32 cache hand-off (check 4).  Returns the
    selective scan's launches on the served run and its row."""
    import numpy as np
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.kernels.mamba_scan.scan import (selective_scan,
                                                     selective_scan_plain)
    from repro_torch.models import api
    torch.cuda.empty_cache()
    cfg = jamba_period()
    check(cfg.dtype("param") == cfg.dtype("compute") == torch.bfloat16,
          "jamba_period is not bf16")
    n_mamba = sum(kind == "mamba" for kind in cfg.attn_layout)
    t0 = time.perf_counter()
    params = api.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"lm serve: {cfg.name} cut to one period ({cfg.n_layers} layers: "
        f"{cfg.n_layers - n_mamba} attention, {n_mamba} Mamba; MoE off), "
        f"d_model {cfg.d_model}, d_inner {cfg.d_inner}, d_state "
        f"{cfg.mamba.d_state}: {n_params} bf16 params drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    # check 1: the served trace, twice
    tokens, counts, stats = serve_lm_trace(cfg, params)
    n_req, max_new = LM_TRACE["requests"], LM_TRACE["max_new"]
    check(sorted(tokens) == list(range(n_req)) and all(
        len(t) == max_new for t in tokens.values()),
        f"lm serve: completions {[(k, len(v)) for k, v in tokens.items()]}")
    check(counts == {"selective_scan": n_mamba * n_req},
          f"lm serve: launched {counts}, expected "
          f"{{'selective_scan': {n_mamba * n_req}}} ({n_mamba} per prefill)")
    launches = counts["selective_scan"]
    tokens2, _, stats2 = serve_lm_trace(cfg, params)
    check(tokens2 == tokens, "lm serve: a second serve of the trace gave "
                             "other tokens")
    trace = lm_trace(cfg)
    ops = first_mamba_operands(cfg, params, trace[0].prompt)
    torch.cuda.synchronize()
    cuda.reset_launches()
    logits, caches, plen = api.prefill_step(
        cfg, params, {"tokens": torch.as_tensor(trace[0].prompt[None, :],
                                                device="cuda")},
        pad_to=LM_TRACE["max_len"])
    torch.cuda.synchronize()
    check(cuda.launch_counts() == {"selective_scan": n_mamba},
          f"one prefill launched {cuda.launch_counts()}")
    check(int(torch.argmax(logits[0])) == tokens[0][0],
          "a lone prefill's first token differs from the served one")
    log(f"lm serve: {n_req} requests x {max_new} tokens through "
        f"{LM_TRACE['slots']} slots (prompt {LM_TRACE['prompt_len']}, "
        f"max_len {LM_TRACE['max_len']}), {stats['decode_ticks']} decode "
        f"ticks; selective_scan launched {launches} times ({n_mamba} per "
        f"prefill, nothing else launched); a second serve gives the same "
        f"tokens; request 0: {tokens[0]}")

    # check 2 and 5
    rng = np.random.default_rng(SEED)
    scan_checks(ops, rng, errs)

    # check 4's bf16 reading (logged, not held)
    bf16_err, bf16_same = handoff_errors(cfg, params, trace[:2])
    log(f"cache hand-off, bf16 served model: relative L2 error "
        f"{', '.join(f'{e:.4e}' for e in bf16_err)}, same argmax "
        f"{bf16_same} (logged; bf16 rounds every layer)")

    # times
    check(tuple(ops[0].shape) + (ops[4].shape[1],) == SCAN_SITE,
          f"the served site's scan is not {SCAN_SITE}")
    y, h = selective_scan(*ops)
    b, t, di = ops[0].shape
    ds = ops[4].shape[1]
    states = b * t * di * ds
    t_bytes = bound_ms(peaks, nbytes(*ops, y, h), 0)[0]
    t_fp32 = bound_ms(peaks, 0, 6 * states)[0]
    t_exp = bound_ms(peaks, 0, states, "mufu_per_s")[0]
    b_ms = max(t_bytes, t_fp32, t_exp)
    clocks = clock_line()
    row = dict(ms=time_ms(lambda: selective_scan(*ops)),
               plain_ms=time_sync_ms(lambda: selective_scan_plain(*ops)),
               library_ms=None, bound_ms=b_ms,
               bound_by="bytes" if t_bytes >= max(t_fp32, t_exp)
               else "operations",
               shape=f"(B, T, Di, Ds) = {(b, t, di, ds)} f32",
               library="none (no single PyTorch call computes a selective "
                       "scan)")
    log(f"selective_scan [{row['shape']}]: {row['ms'] * 1e3:.1f} us, plain "
        f"{row['plain_ms'] * 1e3:.1f} us (call by call), library "
        f"{row['library']}, bound {b_ms * 1e3:.1f} us ({row['bound_by']}; "
        f"bytes {t_bytes * 1e3:.1f} us, FP32 operations "
        f"{t_fp32 * 1e3:.1f} us, exponentials {t_exp * 1e3:.1f} us at the "
        f"MUFU rate) on {card}; SM clock, max, power, temperature before "
        f"the timing: {clocks}, after: {clock_line()}")
    del y, h

    batch = {"tokens": torch.as_tensor(trace[0].prompt[None, :],
                                       device="cuda")}
    prefill_ms = wall_ms(lambda: api.prefill_step(
        cfg, params, batch, pad_to=LM_TRACE["max_len"]), 3)
    slots = LM_TRACE["slots"]
    tick_caches = api.init_decode_caches(cfg, slots, LM_TRACE["max_len"],
                                         device="cuda")
    tick_tokens = torch.ones((slots, 1), dtype=torch.long, device="cuda")
    decode_ms = wall_ms(lambda: api.decode_step(cfg, params, tick_caches,
                                                tick_tokens, plen), 5)
    rate = stats2["tokens"] / stats2["wall_s"]
    log(f"lm serve times: {rate:.1f} tokens/s over the trace ({stats2['tokens']}"
        f" tokens in {stats2['wall_s']:.3f} s, second serve; first "
        f"{stats['tokens'] / stats['wall_s']:.1f}), prefill "
        f"{prefill_ms:.1f} ms a request, decode {decode_ms:.1f} ms a tick "
        f"of {slots} slots (host clock, synchronized; medians of 3 and 5) "
        f"on {card}")
    profile_lm(cfg, params, trace[0].prompt, tick_caches, tick_tokens, plen)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    del params, caches, tick_caches, ops, logits
    torch.cuda.empty_cache()

    # check 3
    seq_vs_step_check(gen)
    torch.cuda.empty_cache()

    # check 4, in f32
    cfg32 = jamba_period(param_dtype="float32", compute_dtype="float32",
                         logit_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    params32 = api.init_params(cfg32, SEED, device="cuda")
    f32_err, f32_same = handoff_errors(cfg32, params32, trace[:2])
    check(all(e <= HANDOFF_REL_L2 for e in f32_err) and all(f32_same),
          f"cache hand-off in f32: relative L2 errors {f32_err}, same "
          f"argmax {f32_same} (limit {HANDOFF_REL_L2})")
    log(f"cache hand-off, f32 one-period model (params, compute and "
        f"logits f32; {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
        f"peak): relative L2 error {', '.join(f'{e:.4e}' for e in f32_err)}"
        f" <= {HANDOFF_REL_L2}, same argmax {f32_same}")
    del params32
    torch.cuda.empty_cache()
    return launches, row


# ---------------------------------------------------------------------------
# "lm families": MoE, RWKV-6, embedding inputs and the encoder-decoder
# ---------------------------------------------------------------------------
def family_config(arch, **replace):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **replace)


def smoke_families():
    """(label, config) for check 2: the 10 architectures' smoke configs
    in f32 with f32 logits, jamba also without MoE, and each MoE arch
    under the scatter dispatch too."""
    import dataclasses
    from repro_torch.configs import ARCH_NAMES, get_config
    out = []
    for arch in ARCH_NAMES:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  logit_dtype="float32")
        out.append((arch, cfg))
        if cfg.moe:
            out.append((f"{arch} scatter", dataclasses.replace(
                cfg, moe_dispatch="scatter")))
    out.append((f"{JAMBA} no MoE", dataclasses.replace(
        get_config(JAMBA, smoke=True), moe=None, logit_dtype="float32")))
    return out


def tree_to(tree, device):
    from repro_torch.models.transformer import tree_map
    return tree_map(lambda t: t.to(device), tree)


def prefill_inputs(cfg, batch, seq, device, seed=SEED):
    """``make_inputs`` for a prefill of ``batch`` x ``seq`` (numpy-seeded,
    the same numbers on every device)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.frontends import make_inputs
    return make_inputs(cfg, ShapeConfig("smoke", seq, batch, "prefill"),
                       seed=seed, abstract=False, device=device)


def step_input(cfg, logits, rng, device):
    """The next decode input: the greedy token, or a seeded (B, 1, D)
    embedding for an ``embed_inputs`` decoder."""
    import torch
    if cfg.embed_inputs and cfg.family != "encdec":
        e = rng.normal(size=(logits.shape[0], 1, cfg.d_model))
        return torch.from_numpy(e.astype("float32")).to(
            dtype=cfg.dtype("compute"), device=device)
    return torch.argmax(logits, dim=-1, keepdim=True).to(device)


def close_trees(what, got, want, tol):
    """Every leaf of ``got`` (on the card) within ``tol`` of ``want`` (on
    the CPU), key for key; returns the largest abs error."""
    import torch
    g, w = dict(_paths(got)), dict(_paths(want))
    check(list(g) == list(w), f"{what}: keys {list(g)} vs {list(w)}")
    worst = 0.0
    for path, t in w.items():
        torch.testing.assert_close(
            g[path].cpu(), t, **tol,
            msg=lambda m: f"{what} {path}, card against CPU: {m}")
        if t.numel():
            worst = max(worst, float((g[path].cpu().double()
                                      - t.double()).abs().max()))
    return worst


def smoke_family_checks(card):
    """Check 2: each smoke config of ``smoke_families`` on the card equals
    the port on the CPU (prefill logits and caches, two decode steps),
    and a token-in arch serves the same tokens through
    ``serve_requests``; no hand-written kernel is on these paths."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.launch.serve import make_requests, serve_requests
    from repro_torch.models import api
    for label, cfg in smoke_families():
        params = api.init_params(cfg, SEED, device="cpu")
        on = {"cpu": params, "cuda": tree_to(params, "cuda")}
        out = {}
        torch.cuda.synchronize()
        cuda.reset_launches()
        for dev, p in on.items():
            rng = np.random.default_rng(SEED)
            batch = prefill_inputs(cfg, 2, 16, dev)
            logits, caches, s = api.prefill_step(cfg, p, batch, pad_to=24)
            steps = [{"logits": logits, "caches": caches}]
            for i in range(2):   # both devices take the CPU's next input
                prev = (steps if dev == "cpu" else out["cpu"])[i]["logits"]
                nxt = step_input(cfg, prev, rng, dev)
                logits, caches = api.decode_step(cfg, p, caches, nxt, s + i)
                steps.append({"logits": logits, "caches": caches})
            out[dev] = steps
        errs = [close_trees(f"{label} step {i}", g, w, FAMILY_TOL)
                for i, (g, w) in enumerate(zip(out["cuda"], out["cpu"]))]
        served = ""
        if not cfg.embed_inputs:
            tokens = {}
            for dev, p in on.items():
                reqs = make_requests(cfg, 6, 16, 8,
                                     np.random.default_rng(SEED))
                done, _ = serve_requests(cfg, p, reqs, slots=3, max_len=40,
                                         device=dev)
                tokens[dev] = {r.rid: r.generated for r in done}
            check(tokens["cuda"] == tokens["cpu"] and len(tokens["cpu"]) == 6,
                  f"{label}: served tokens on the card differ from the CPU's")
            served = "; 6 requests served through 3 slots, tokens equal"
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        mamba = "mamba" in cfg.attn_layout
        check(set(counts) == ({"selective_scan"} if mamba else set()),
              f"{label}: launched {counts}")
        log(f"lm families smoke {label}: card == CPU within "
            f"rtol={FAMILY_TOL['rtol']}, atol={FAMILY_TOL['atol']} (prefill "
            f"+ 2 decode steps, logits and caches; max abs err "
            f"{max(errs):.3e}){served}; launched {counts}")
    torch.cuda.empty_cache()


def wall_ms(fn, reps):
    """Median host wall (ms) of ``fn``, synchronized at both ends."""
    import torch
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    return statistics.median(walls)


def weight_read_bytes(cfg, params):
    """Bytes of weights one decode tick reads: every param tensor but an
    untied embedding table (a tick gathers B rows of it) and an
    encoder's (run once, at prefill)."""
    skip = {"enc_blocks", "enc_norm"} | (set() if cfg.tie_embeddings
                                         else {"embed"})
    return sum(nbytes(t) for k, sub in params.items() if k not in skip
               for t in _leaves(sub))


def tick_note(peaks, cfg, params, caches, tick_ms):
    """The decode tick's bound: weights plus the caches it reads, over
    the memory rate."""
    w = weight_read_bytes(cfg, params)
    c = sum(nbytes(t) for t in _leaves(caches))
    b_ms = (w + c) / peaks["bytes_per_s"] * 1e3
    return (f"decode {tick_ms:.2f} ms a tick, weight-read bound "
            f"{b_ms:.2f} ms ({w / 1e9:.2f} GB of weights + {c / 1e9:.3f} "
            f"GB of caches at {peaks['bytes_per_s'] / 1e12:.2f} TB/s; "
            f"{b_ms / tick_ms:.3f} of it)")


def served_family(peaks, card, cfg, params, spec, what):
    """Check 1 and the times for a token-in family: ``spec``'s trace
    through ``serve_requests`` twice (every request completes, the same
    tokens, no kernel launched), one prefill and one decode tick timed."""
    import torch
    from repro_torch.models import api
    torch.cuda.reset_peak_memory_stats()
    tokens, counts, stats = serve_lm_trace(cfg, params, spec)
    n_req, max_new = spec["requests"], spec["max_new"]
    check(sorted(tokens) == list(range(n_req)) and all(
        len(t) == max_new for t in tokens.values()),
        f"{what}: completions {[(k, len(v)) for k, v in tokens.items()]}")
    check(counts == {}, f"{what}: launched {counts}")
    tokens2, _, stats2 = serve_lm_trace(cfg, params, spec)
    check(tokens2 == tokens, f"{what}: a second serve gave other tokens")
    prompt = lm_trace(cfg, spec)[0].prompt
    batch = {"tokens": torch.as_tensor(prompt[None, :], device="cuda")}
    holder = {}

    def prefill():
        holder["out"] = api.prefill_step(cfg, params, batch,
                                         pad_to=spec["max_len"])

    prefill_ms = wall_ms(prefill, 3)
    plen = holder.pop("out")[2]
    caches = api.init_decode_caches(cfg, spec["slots"], spec["max_len"],
                                    device="cuda")
    tick_tokens = torch.ones((spec["slots"], 1), dtype=torch.long,
                             device="cuda")
    tick_ms = wall_ms(lambda: api.decode_step(cfg, params, caches,
                                              tick_tokens, plen), 5)
    rate = stats2["tokens"] / stats2["wall_s"]
    log(f"{what}: {n_req} requests x {max_new} tokens through "
        f"{spec['slots']} slots (prompt {spec['prompt_len']}, max_len "
        f"{spec['max_len']}), {stats['decode_ticks']} decode ticks, every "
        f"request complete, the same tokens twice, no kernel launched; "
        f"{rate:.1f} tokens/s over the trace ({stats2['tokens']} tokens in "
        f"{stats2['wall_s']:.3f} s, second serve; first "
        f"{stats['tokens'] / stats['wall_s']:.1f}), prefill "
        f"{prefill_ms:.1f} ms a request, "
        f"{tick_note(peaks, cfg, params, caches, tick_ms)}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
        f"(host clock, synchronized; medians of 3 and 5) on {card}; "
        f"request 0: {tokens[0]}")
    profile_tick(cfg, params, caches, tick_tokens, plen,
                 f"{what.split()[0]} decode tick", tick_ms,
                 top=8 if cfg.moe else 3)


def profile_tick(cfg, params, caches, tick_tokens, tick_pos, what,
                 wall_tick_ms, top=8):
    """One decode tick under ``torch.profiler``: device time by op (the
    ``top`` rows) and the device's busy share of the tick's wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import api
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        api.decode_step(cfg, params, caches, tick_tokens, tick_pos)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
        if dev > 0 and not ev.key.startswith(("aten::", "Activity")):
            rows.append((dev, ev.key, ev.count))
    busy = sum(r[0] for r in rows)
    check(busy > 0, f"the profiler saw no device time in the {what}")
    for dev, key, count in sorted(rows, reverse=True)[:top]:
        log(f"lm families profile {what}: {dev:10.1f} us device "
            f"x{count:<4d} ({dev / busy:.4f}) {key[:70]}")
    log(f"lm families profile {what}: device busy {busy:.1f} us in "
        f"{sum(r[2] for r in rows)} kernels, {busy / 1e3 / wall_tick_ms:.3f}"
        f" of the tick's unprofiled wall ({wall_tick_ms:.2f} ms)")


def dbrx_family(peaks, card):
    """dbrx cut to ``DBRX_LAYERS`` layers, bf16, MoE on: ``LM_TRACE``
    twice (check 1), the tick's profile, and both dispatch modes' first
    prefill (check 4)."""
    import dataclasses
    import torch
    from repro_torch.models import api
    from repro_torch.models.transformer import moe_num_groups
    cfg = family_config(DBRX, n_layers=DBRX_LAYERS)
    check(cfg.moe is not None and cfg.moe_dispatch == "einsum"
          and cfg.dtype("param") == torch.bfloat16,
          f"{DBRX} cut: MoE {cfg.moe}, dispatch {cfg.moe_dispatch}, params "
          f"{cfg.param_dtype}")
    t0 = time.perf_counter()
    params = api.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"lm families: {DBRX} cut to {cfg.n_layers} of 40 layers, MoE "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} capacity "
        f"{cfg.moe.capacity_factor}, d_model {cfg.d_model}, d_ff "
        f"{cfg.d_ff}: {n} bf16 params drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    served_family(peaks, card, cfg, params, LM_TRACE, f"{DBRX} serve")
    prompt = lm_trace(cfg)[0].prompt
    batch = {"tokens": torch.as_tensor(prompt[None, :], device="cuda")}
    scatter = dataclasses.replace(cfg, moe_dispatch="scatter")
    logits, times = {}, {}
    for name, c in (("einsum", cfg), ("scatter", scatter)):
        logits[name] = api.prefill_step(c, params, batch)[0].double()
        times[name] = wall_ms(lambda: api.prefill_step(c, params, batch), 3)
    d = logits["scatter"] - logits["einsum"]
    rel = float(d.norm() / logits["einsum"].norm())
    same = bool(torch.equal(logits["scatter"].argmax(-1),
                            logits["einsum"].argmax(-1)))
    check(rel <= DISPATCH_REL_L2 and same,
          f"{DBRX}: scatter's first prefill logits against einsum's: "
          f"relative L2 {rel:.3e} (limit {DISPATCH_REL_L2}), same argmax "
          f"{same}")
    log(f"{DBRX} dispatch modes at full width (prompt "
        f"{LM_TRACE['prompt_len']}, {moe_num_groups(LM_TRACE['prompt_len'])}"
        f" groups): scatter's logits within "
        f"relative L2 {rel:.3e} <= {DISPATCH_REL_L2} of einsum's (max abs "
        f"{float(d.abs().max()):.3e}, same argmax); prefill einsum "
        f"{times['einsum']:.1f} ms, scatter {times['scatter']:.1f} ms "
        f"(host clock, synchronized; medians of 3) on {card}")
    del params
    torch.cuda.empty_cache()


def rwkv_family(peaks, card):
    """rwkv6-3b whole (f32 params, bf16 compute): ``RWKV_TRACE`` twice."""
    import torch
    from repro_torch.models import api
    cfg = family_config(RWKV)
    t0 = time.perf_counter()
    params = api.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"lm families: {RWKV} whole ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, head size {cfg.rwkv.head_size}): {n} f32 params "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s; the time "
        f"loop runs {RWKV_TRACE['prompt_len']} steps a layer a prefill")
    served_family(peaks, card, cfg, params, RWKV_TRACE, f"{RWKV} serve")
    del params
    torch.cuda.empty_cache()


def embed_family(peaks, card, cfg, inputs, steps, pad_to, what):
    """Check 1 and the times for an embedding-input family: a prefill on
    ``inputs`` then ``steps`` decode steps (seeded embeddings for a
    decoder-only stack, the greedy token for the encoder-decoder), run
    twice: the same greedy tokens, no kernel launched."""
    import numpy as np
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.models import api
    t0 = time.perf_counter()
    params = api.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"lm families: {what} ({cfg.n_layers} decoder layers"
        f"{f', {cfg.enc_layers} encoder layers' if cfg.enc_layers else ''}"
        f", d_model {cfg.d_model}): {n} {cfg.param_dtype} params drawn on "
        f"the card in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()

    def run():
        rng = np.random.default_rng(SEED + 1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, caches, s = api.prefill_step(cfg, params, inputs,
                                             pad_to=pad_to)
        out = [logits.argmax(-1)]
        ticks = []
        for i in range(steps):
            nxt = step_input(cfg, logits, rng, "cuda")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            logits, caches = api.decode_step(cfg, params, caches, nxt, s + i)
            out.append(logits.argmax(-1))
            torch.cuda.synchronize()
            ticks.append((time.perf_counter() - t2) * 1e3)
        wall = time.perf_counter() - t1
        return torch.stack(out, 1).cpu(), (caches, logits), ticks, wall, s

    torch.cuda.synchronize()
    cuda.reset_launches()
    tokens, _, _, wall1, _ = run()
    torch.cuda.synchronize()
    check(cuda.launch_counts() == {}, f"{what}: launched "
                                      f"{cuda.launch_counts()}")
    tokens2, (caches, last), ticks, wall, s = run()
    check(tuple(tokens.shape) == (inputs[next(iter(inputs))].shape[0],
                                  steps + 1)
          and torch.equal(tokens, tokens2),
          f"{what}: the second run's greedy tokens differ")
    prefill_ms = wall_ms(lambda: api.prefill_step(cfg, params, inputs,
                                                  pad_to=pad_to), 3)
    tick_ms = statistics.median(ticks)
    n_tok = tokens.numel()
    log(f"{what}: prefill on {', '.join(f'{k} {tuple(v.shape)}' for k, v in inputs.items())}"
        f" then {steps} decode steps, twice: the same greedy tokens, no "
        f"kernel launched; {n_tok / wall:.1f} tokens/s ({n_tok} tokens in "
        f"{wall:.3f} s, second run; first {n_tok / wall1:.1f}), prefill "
        f"{prefill_ms:.1f} ms, "
        f"{tick_note(peaks, cfg, params, caches, tick_ms)}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB (host clock, "
        f"synchronized; medians of 3 and {steps}) on {card}; row 0: "
        f"{tokens[0].tolist()}")
    # the last step again (its cache row rewritten), profiled
    profile_tick(cfg, params, caches, step_input(
        cfg, last, np.random.default_rng(SEED), "cuda"), s + steps - 1,
        f"{what.split()[0]} decode tick", tick_ms, top=3)
    del params, caches, last
    torch.cuda.empty_cache()


def family_seq_vs_step(card):
    """Check 3: rwkv, llava and seamless at full width in f32, cut to
    ``SEQ_FAMILY_LAYERS`` layers: a prefill over S+1 positions gives the
    last-position logits of a prefill over S followed by one
    ``decode_step`` (relative L2 <= ``HANDOFF_REL_L2``, same argmax)."""
    import torch
    from repro_torch.models import api
    f32 = dict(param_dtype="float32", compute_dtype="float32",
               logit_dtype="float32")
    cases = ((RWKV, dict(n_layers=SEQ_FAMILY_LAYERS)),
             (LLAVA, dict(n_layers=SEQ_FAMILY_LAYERS)),
             (SEAMLESS, dict(n_layers=SEQ_FAMILY_LAYERS,
                             enc_layers=SEQ_FAMILY_LAYERS)))
    for arch, cut in cases:
        cfg = family_config(arch, **cut, **f32)
        params = api.init_params(cfg, SEED, device="cuda")
        batch = prefill_inputs(cfg, 2, SEQ_FAMILY_LEN + 1, "cuda")
        key = "tokens" if "tokens" in batch else "embeds"
        full = api.prefill_step(cfg, params, batch)[0].double()
        head = dict(batch, **{key: batch[key][:, :-1]})
        _, caches, s = api.prefill_step(cfg, params, head,
                                        pad_to=SEQ_FAMILY_LEN + 1)
        step = api.decode_step(cfg, params, caches, batch[key][:, -1:],
                               s)[0].double()
        rel = float((step - full).norm() / full.norm())
        same = bool(torch.equal(step.argmax(-1), full.argmax(-1)))
        check(rel <= HANDOFF_REL_L2 and same,
              f"{arch} f32 seq vs step: relative L2 {rel:.3e}, same argmax "
              f"{same} (limit {HANDOFF_REL_L2})")
        log(f"lm families seq vs step, {arch} f32 at full width cut to "
            f"{SEQ_FAMILY_LAYERS} layers: prefill over "
            f"{SEQ_FAMILY_LEN + 1} positions against {SEQ_FAMILY_LEN} + one "
            f"decode step, relative L2 {rel:.3e} <= {HANDOFF_REL_L2}, same "
            f"argmax")
        del params, caches
        torch.cuda.empty_cache()


def lm_families_phase(peaks, card):
    """The nineteenth slice's path: MoE (dbrx), RWKV-6, embedding inputs
    (llava) and the encoder-decoder (seamless) at full width, then checks
    2 and 3.  Prints the phase's wall time."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    dbrx_family(peaks, card)
    rwkv_family(peaks, card)
    llava = family_config(LLAVA, n_layers=LLAVA_LAYERS)
    embed_family(peaks, card, llava,
                 prefill_inputs(llava, LLAVA_CASE["batch"],
                                LLAVA_CASE["prompt"], "cuda"),
                 LLAVA_CASE["steps"],
                 LLAVA_CASE["prompt"] + LLAVA_CASE["steps"],
                 f"{LLAVA} cut to {LLAVA_LAYERS} of 60 layers, bf16")
    seamless = family_config(SEAMLESS)
    inputs = prefill_inputs(seamless, SEAMLESS_CASE["batch"],
                            SEAMLESS_CASE["frames"], "cuda")
    inputs["tokens"] = inputs["tokens"][:, :SEAMLESS_CASE["prompt"]]
    embed_family(peaks, card, seamless, inputs, SEAMLESS_CASE["steps"],
                 SEAMLESS_CASE["pad_to"], f"{SEAMLESS} whole")
    del inputs
    smoke_family_checks(card)
    family_seq_vs_step(card)
    log(f"lm families: phase wall {time.perf_counter() - t0:.1f} s on "
        f"{card}")


# ---------------------------------------------------------------------------
# "train": training on one card
# ---------------------------------------------------------------------------
def scan_grad_data(rng, b, t, di, ds):
    """``scan_data`` and the gradients fed back: dy (B, T, Di) and dh
    (B, Di, Ds), N(0, 1), numpy-seeded, on the card."""
    import numpy as np
    import torch
    f = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
    ops = scan_data(rng, b, t, di, ds)
    return ops, f(rng.normal(size=(b, t, di))), f(rng.normal(size=(b, di,
                                                                   ds)))


def scan_vjp(ops, dy, dh, dtype):
    """The recurrence's gradient by autograd through the oracle's steps
    (``selective_scan_ref``'s) on ``dtype`` operands: in f64 the witness
    the kernel's gradients are measured against, in f32 the oracle's own
    (what ``jax.grad`` of the reference's ``lax.scan`` computes)."""
    import torch
    leaves = [v.detach().to(dtype, copy=True).requires_grad_(True)
              for v in ops]
    x, dt, bp, cp, a = leaves
    dy = dy.to(dtype)
    h = torch.zeros((x.shape[0], x.shape[2], a.shape[1]), dtype=dtype,
                    device=x.device)
    loss = 0
    for i in range(x.shape[1]):
        d = dt[:, i]
        h = (torch.exp(d[..., None] * a[None]) * h
             + (d * x[:, i])[..., None] * bp[:, i, None, :])
        loss = loss + ((h * cp[:, i, None, :]).sum(-1) * dy[:, i]).sum()
    if dh is not None:
        loss = loss + (h * dh.to(dtype)).sum()
    return torch.autograd.grad(loss, leaves)


def compare_saving_forward(what, ops, errs):
    """``selective_scan_fwd`` (the forward's instance that saves states,
    whose y and h training's ``SelectiveScan`` returns) bitwise equal to
    the plain version and to serving's ``selective_scan``.  Returns its
    saved states."""
    import torch
    from repro_torch.kernels.mamba_scan.scan import (
        selective_scan, selective_scan_fwd, selective_scan_plain)
    y, h, states = selective_scan_fwd(*ops)
    for g, w in zip((y, h), selective_scan_plain(*ops)):
        compare("selective_scan", g, w, 0, 0, errs, exact=True)
    check(all(torch.equal(g, w) for g, w in zip((y, h),
                                                selective_scan(*ops))),
          f"selective_scan_fwd {what}: y or h differs from serving's "
          f"forward")
    log(f"selective_scan_fwd {what}: y and h bitwise equal to the plain "
        f"version and to serving's forward")
    return states


def compare_scan_bwd(what, ops, states, dy, dh, errs, witness=False):
    """``selective_scan_bwd`` (one launch) bitwise equal to its plain
    version, on the ``states`` of a forward checked by
    ``compare_saving_forward``; with ``witness``, measured
    against the recurrence's gradient in f64: the error's RMS within
    ``BWD_F64_TOL["rms"]`` of each gradient's RMS, and its largest
    element within ``BWD_F64_TOL["oracle"]`` times the f32 oracle's
    (``scan_vjp`` in f32)."""
    import torch
    from repro_torch.kernels.mamba_scan.scan import (
        selective_scan_bwd, selective_scan_bwd_plain)
    got = launched_once(lambda: selective_scan_bwd(*ops, states, dy, dh),
                        "selective_scan_bwd", what)
    for g, w in zip(got, selective_scan_bwd_plain(*ops, dy, dh)):
        compare("selective_scan_bwd", g, w, 0, 0, errs, exact=True)
    again = selective_scan_bwd(*ops, states, dy, dh)
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          f"selective_scan_bwd {what}: two launches on the same operands "
          f"differ")
    del again
    notes = ""
    if witness:
        exact = scan_vjp(ops, dy, dh, torch.float64)
        oracle = [g.detach() for g in scan_vjp(ops, dy, dh, torch.float32)]
        parts = []
        for name, g, o, w in zip(("dx", "ddt", "dBp", "dCp", "dA"), got,
                                 oracle, exact):
            rms = float(w.pow(2).mean().sqrt())
            e_rms = float((g.double() - w).pow(2).mean().sqrt())
            e_max = float((g.double() - w).abs().max())
            o_max = float((o.double() - w).abs().max())
            check(e_rms <= BWD_F64_TOL["rms"] * rms,
                  f"selective_scan_bwd {what}, {name}: error RMS {e_rms:.3e}"
                  f" against the f64 recurrence's gradient, over "
                  f"{BWD_F64_TOL['rms']:.0e} of its RMS {rms:.3e}")
            check(e_max <= BWD_F64_TOL["oracle"] * o_max,
                  f"selective_scan_bwd {what}, {name}: max abs error "
                  f"{e_max:.3e} against the f64 gradient, the f32 "
                  f"oracle's {o_max:.3e}")
            parts.append(f"{name} RMS {rms:.3e}, error RMS "
                         f"{e_rms / rms:.2e} of it, max {e_max / rms:.2e} "
                         f"(oracle {o_max / rms:.2e})")
        del exact, oracle
        notes = (f"; against the f64 recurrence's gradient: "
                 f"{'; '.join(parts)}")
    log(f"selective_scan_bwd {what}, dh "
        f"{'given' if dh is not None else 'None'}: one launch, bitwise "
        f"equal to the plain version and to a second launch{notes}")
    return got


def scan_bwd_checks(peaks, card, errs):
    """(a): the forward that saves states (y and h) and the backward
    kernel against their plain versions at the served site,
    SCAN_FULL_CASES, SCAN_SMALL_CASES and the d_states of SCAN_DS_CASES,
    the backward with dh given and None; at full width also against
    the f64 recurrence; then at each SCAN_BWD_TIMED shape its time, the
    plain version's and the bound, beside the forward's with and
    without saving states and their bounds.  Returns the served site's
    row."""
    import numpy as np
    import torch
    from repro_torch.kernels.mamba_scan import scan
    from repro_torch.kernels.mamba_scan.scan import (
        bwd_plan, n_saved, selective_scan, selective_scan_bwd,
        selective_scan_bwd_plain, selective_scan_fwd)
    rng = np.random.default_rng(SEED)
    for case in SCAN_FULL_CASES + SCAN_SMALL_CASES + SCAN_DS_CASES:
        ops, dy, dh = scan_grad_data(rng, *case)
        states = compare_saving_forward(f"{case}", ops, errs)
        for g in (dh, None):
            compare_scan_bwd(f"{case} (plan {tuple(bwd_plan(case[3]))})",
                             ops, states, dy, g, errs,
                             witness=case[2] >= 16384 and g is not None)
        del ops, dy, dh, states
        torch.cuda.empty_cache()
    rows = {}
    for shape in SCAN_BWD_TIMED:
        ops, dy, _ = scan_grad_data(rng, *shape)
        states = compare_saving_forward(f"{shape}", ops, errs)
        grads = selective_scan_bwd(*ops, states, dy, None)
        y, h = selective_scan(*ops)
        b, t, di, ds = shape
        n = b * t * di * ds
        # the backward's bytes: the inputs (x, dt, Bp, Cp, A, the saved
        # states, dy) read once and the gradients written once;
        # operations: per (t, di, s) one exponential (a_t) and
        # scan.BWD_FP32_OPS FP32 operations (the chunk's recompute of h, the g
        # update, the terms of dx, ddt, dB, dC and dA, their sums).  The
        # forward's: x, dt, Bp, Cp, A read, y and h (and the states)
        # written; per (t, di, s) one exponential and 6 FP32 operations.
        bounds = {}
        for name, n_bytes, fp32 in (
                ("bwd", nbytes(*ops, states, dy, *grads), scan.BWD_FP32_OPS),
                ("fwd", nbytes(*ops, y, h), scan.FWD_FP32_OPS),
                ("fwd_save", nbytes(*ops, y, h, states), scan.FWD_FP32_OPS)):
            parts = (bound_ms(peaks, n_bytes, 0)[0],
                     bound_ms(peaks, 0, fp32 * n)[0],
                     bound_ms(peaks, 0, n, "mufu_per_s")[0])
            bounds[name] = (max(parts), n_bytes, *parts)
        clocks = clock_line()
        row = dict(ms=time_ms(lambda: selective_scan_bwd(*ops, states, dy,
                                                         None), reps=10,
                              warmup=2),
                   plain_ms=time_sync_ms(lambda: selective_scan_bwd_plain(
                       *ops, dy, None), reps=1),
                   library_ms=None, bound_ms=bounds["bwd"][0],
                   bound_by="bytes" if bounds["bwd"][2] >= max(
                       bounds["bwd"][3:]) else "operations",
                   shape=f"(B, T, Di, Ds) = {shape} f32, dh None, "
                         f"{n_saved(t)} saved states a row",
                   library="none (no single PyTorch call computes a "
                           "selective scan's gradient)")
        fwd_ms = time_ms(lambda: selective_scan(*ops), reps=10)
        save_ms = time_ms(lambda: selective_scan_fwd(*ops), reps=10)
        _, n_bytes, t_bytes, t_fp32, t_exp = bounds["bwd"]
        log(f"selective_scan_bwd [{row['shape']}]: {row['ms'] * 1e3:.1f} "
            f"us, plain {row['plain_ms'] * 1e3:.1f} us (one call), library "
            f"{row['library']}, bound {row['bound_ms'] * 1e3:.1f} us "
            f"({row['bound_by']}; {n_bytes / 1e6:.1f} MB "
            f"{t_bytes * 1e3:.1f} us, FP32 operations {t_fp32 * 1e3:.1f} "
            f"us, exponentials {t_exp * 1e3:.1f} us at the MUFU rate), "
            f"{row['ms'] / row['bound_ms']:.2f}x it; the forward "
            f"{fwd_ms * 1e3:.1f} us (bound {bounds['fwd'][0] * 1e3:.1f} "
            f"us), saving its states {save_ms * 1e3:.1f} us (bound "
            f"{bounds['fwd_save'][0] * 1e3:.1f} us, "
            f"{bounds['fwd_save'][1] / 1e6:.1f} MB): "
            f"{save_ms / fwd_ms:.3f}x; on {card}; SM clock, max, power, "
            f"temperature before: {clocks}, after: {clock_line()}")
        rows[shape] = row
        del ops, dy, states, grads, y, h
        torch.cuda.empty_cache()
    return rows[SCAN_SITE]


def state_to(state, device):
    """A copy of a ``TrainState`` with params and moments on ``device``
    (the step counter stays on the host)."""
    from repro_torch.models.api import TrainState
    from repro_torch.models.transformer import tree_map
    from repro_torch.optim.adamw import OptState
    cp = lambda tree: tree_map(  # noqa: E731
        lambda t: t.to(device, copy=True), tree)
    return TrainState(cp(state.params), OptState(
        cp(state.opt.mu), cp(state.opt.nu), state.opt.step.clone()))


def loss_grads(cfg, params, batch):
    """(loss, grads in ``tree_leaves`` order) of ``api.loss_fn``."""
    import torch
    from repro_torch.models import api
    from repro_torch.optim.adamw import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = api.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


class WideTorch:
    """``torch`` with ``float32`` read as ``float64``, all else
    delegated."""

    def __init__(self):
        import torch
        self._mod, self.float32 = torch, torch.float64

    def __getattr__(self, name):
        return getattr(self._mod, name)


def f64_grads(cfg, params, batch):
    """The port's gradient in f64 throughout on the CPU: params and
    every config dtype in f64, and the model modules' casts to f32 by
    name (norms, the RWKV recurrence, the loss) widened, as
    tests/test_torch_train.py takes it, where it equals the reference's
    f64 gradient within 1e-8 of each leaf's RMS."""
    import dataclasses
    import torch
    from repro_torch.models import blocks, rwkv, transformer
    wide = dataclasses.replace(cfg, **{f"{k}_dtype": "float64" for k in (
        "param", "compute", "logit", "attn_score")})
    mods = (blocks, rwkv, transformer)
    for m in mods:
        m.torch = WideTorch()
    try:
        return loss_grads(wide, transformer.tree_map(
            lambda t: t.to("cpu", torch.float64), params),
            {k: v.cpu() for k, v in batch.items()})[1]
    finally:
        for m in mods:
            m.torch = torch


def smoke_train_checks(card):
    """(b): every smoke config of ``smoke_families`` takes one
    ``train_step`` on the card and on the CPU from the same state: loss,
    grad_norm and grads within FAMILY_TOL, params within the CPU tests'
    bar (TRAIN_PARAM_TOL where the CPU's gradient is settled, 2 lr
    everywhere); rwkv's grads as tests/test_torch_train.py holds them
    (each leaf's f32 error against the f64 gradient, ``f64_grads``,
    within RWKV_ERR_FACTOR of the CPU's); only jamba launches kernels: the
    scan's forward and backward."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import cuda
    from repro_torch.models import api
    from repro_torch.models.frontends import make_inputs
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    opt = AdamWConfig(warmup_steps=2, total_steps=10)
    for label, cfg in smoke_families():
        state0 = api.init_train_state(cfg, opt, SEED, device="cpu")
        out = {}
        for dev in ("cpu", "cuda"):
            batch = make_inputs(cfg, ShapeConfig("smoke_train", 32, 2,
                                                 "train"),
                                seed=SEED, abstract=False, device=dev)
            state = state_to(state0, dev)
            torch.cuda.synchronize()
            cuda.reset_launches()
            loss, grads = loss_grads(cfg, state.params, batch)
            new, metrics = api.train_step(cfg, opt, state, batch)
            torch.cuda.synchronize()
            out[dev] = (loss, grads, new, metrics, cuda.launch_counts())
        (c_loss, c_g, c_new, c_m, _), (g_loss, g_g, g_new, g_m, counts) = (
            out["cpu"], out["cuda"])
        torch.testing.assert_close(g_loss.cpu(), c_loss, **FAMILY_TOL)
        for k in ("loss", "xent", "aux", "lr") + (
                () if label == RWKV else ("grad_norm",)):
            torch.testing.assert_close(
                g_m[k].cpu(), c_m[k], **FAMILY_TOL,
                msg=lambda m: f"train {label} {k}, card against CPU: {m}")
        exact = f64_grads(cfg, state0.params, make_inputs(
            cfg, ShapeConfig("smoke_train", 32, 2, "train"), seed=SEED,
            abstract=False, device="cpu")) if label == RWKV else None
        lr = float(c_m["lr"])
        worst = ratio = 0.0
        for i, (gg, cg, gp, cp) in enumerate(zip(
                g_g, c_g, tree_leaves(g_new.params),
                tree_leaves(c_new.params))):
            gg = gg.cpu()
            if exact is None:
                torch.testing.assert_close(
                    gg, cg, **FAMILY_TOL,
                    msg=lambda m: f"train {label} grad {i}: {m}")
                atol = FAMILY_TOL["atol"]
            else:
                e = exact[i]
                mine = float((gg.double() - e).abs().max())
                ref = float((cg.double() - e).abs().max())
                floor = 1e-4 * float(e.pow(2).mean().sqrt())
                check(mine <= max(RWKV_ERR_FACTOR * ref, floor),
                      f"train {label} grad {i}: card error {mine:.3e} "
                      f"against the f64 gradient, CPU's {ref:.3e}")
                ratio = max(ratio, mine / ref if ref else 0.0)
                atol = float((gg - cg).abs().max())
            worst = max(worst, float((gg - cg).abs().max()))
            settled = cg.abs() > atol + FAMILY_TOL["rtol"] * cg.abs()
            gp, cp = gp.cpu().float(), cp.float()
            torch.testing.assert_close(
                gp[settled], cp[settled], **TRAIN_PARAM_TOL,
                msg=lambda m: f"train {label} param {i}: {m}")
            check(float((gp - cp).abs().max()) <= 2 * lr,
                  f"train {label} param {i} moved more than 2 lr apart")
        mamba = "mamba" in cfg.attn_layout
        check(set(counts) == ({"selective_scan", "selective_scan_bwd"}
                              if mamba else set()),
              f"train {label}: launched {counts}")
        held = (f" (held against the f64 gradient: card error up to "
                f"{ratio:.4f}x the CPU's)" if exact is not None else "")
        log(f"train smoke {label}: one train_step, card == CPU (loss "
            f"{float(g_m['loss']):.6f} vs {float(c_m['loss']):.6f}, "
            f"grad_norm {float(g_m['grad_norm']):.6f} vs "
            f"{float(c_m['grad_norm']):.6f}; grads max abs diff "
            f"{worst:.3e}{held}"
            f"; params within the bar); launched {counts}")
    torch.cuda.empty_cache()


def run_train(argv):
    """``repro_torch.launch.train.train(argv)`` with its output captured
    and echoed: (exit code, losses, step ms list, save seconds, text)."""
    import contextlib
    import io
    from repro_torch.launch.train import train
    buf = io.StringIO()
    code = 0
    returned = None
    with contextlib.redirect_stdout(buf):
        try:
            returned = train(list(argv))
        except SystemExit as e:
            code = e.code
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  {line}")
    steps = [line for line in text.splitlines()
             if line.startswith("[train] step")]
    # the losses ``train`` returns, unrounded; the printed ones of a run
    # that exited
    losses = returned if returned is not None else [
        float(line.split("loss")[1].split()[0]) for line in steps]
    step_ms = [float(line.split()[-2]) for line in steps]
    saves = [float(line.split(" in ")[1].split()[0])
             for line in text.splitlines()
             if line.startswith("[train] saved step")]
    return code, losses, step_ms, (saves[-1] if saves else None), text


def llama_train_run(card):
    """(c): llama3.2-1b whole, at full width, through the trainer (a
    (1, 1) mesh on the card): every loss finite, the last below the
    first, nothing hand-written launched; step ms, tokens/s, the final
    save and peak memory.  Returns the losses ("train mesh" (e) holds
    them to the single-device step's)."""
    import math
    import shutil
    import tempfile
    import torch
    from repro_torch.kernels import cuda
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        cuda.reset_launches()
        t0 = time.perf_counter()
        code, losses, step_ms, save_s, _ = run_train(
            ("--arch", TRAIN_LLAMA, *TRAIN_LLAMA_ARGS, "--log-every", "1",
             "--ckpt-dir", ckdir))
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = cuda.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        size = ckpt_bytes(ckdir)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    check(code == 0, f"train {TRAIN_LLAMA}: exit code {code}")
    check(len(losses) == TRAIN_LLAMA_STEPS and all(
        math.isfinite(v) for v in losses), f"train {TRAIN_LLAMA}: losses "
                                            f"{losses}")
    check(losses[-1] < losses[0], f"train {TRAIN_LLAMA}: the loss did not "
                                  f"fall: {losses}")
    check(counts == {}, f"train {TRAIN_LLAMA}: launched {counts}")
    steady = statistics.median(step_ms[1:])
    tokens = TRAIN_LLAMA_TOKENS
    log(f"train {TRAIN_LLAMA} whole (f32 params and moments, remat "
        f"block) through repro_torch.launch.train {' '.join(TRAIN_LLAMA_ARGS)}"
        f": losses {', '.join(f'{v:.4f}' for v in losses)}; step "
        f"{step_ms[0]:.1f} ms first, {steady:.1f} ms median of the rest "
        f"({tokens / steady * 1e3:.1f} tokens/s); final checkpoint "
        f"{size / 1e9:.2f} GB saved in {save_s:.2f} s; peak "
        f"{peak / 2**30:.2f} GiB allocated; run wall {wall:.1f} s; "
        f"nothing hand-written launched; on {card}")
    return losses


def jamba_train_run(card):
    """(d), the phase's main path: ``jamba_period`` (bf16 params, grads
    and moments) takes TRAIN_JAMBA["steps"] ``train_step``s with the
    counters reset just before and read just after: each step launches
    the scan's forward 14 times (7 layers, then the remat's recompute)
    and its backward 7 times, nothing else hand-written.  Every loss
    finite, params move; step ms, tokens/s, peak memory, and one
    profiled step.  Returns the backward's launches."""
    import math
    import torch
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.kernels import cuda
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = jamba_period()
    n_mamba = sum(kind == "mamba" for kind in cfg.attn_layout)
    opt = AdamWConfig(warmup_steps=2, total_steps=10,
                      moment_dtype=cfg.moment_dtype)
    state = api.init_train_state(cfg, opt, SEED, device="cuda")
    n_params = sum(t.numel() for t in _leaves(state.params))
    state_bytes = sum(nbytes(t) for t in _leaves(state.params)) * 4
    b, s, steps = (TRAIN_JAMBA[k] for k in ("batch", "seq", "steps"))
    data = make_pipeline(cfg.vocab_size, s, b, seed=SEED)
    probe = state.params["blocks"]["sub1"]["mamba"]["in_proj"]
    before = probe[0, :4, :4].clone()
    losses, walls = [], []
    torch.cuda.synchronize()
    cuda.reset_launches()
    for i in range(steps):
        batch = {k: v.cuda() for k, v in data[i].items()}
        t0 = time.perf_counter()
        state, metrics = api.train_step(cfg, opt, state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = cuda.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"selective_scan": 2 * n_mamba * steps,
            "selective_scan_bwd": n_mamba * steps}
    check(counts == want, f"train jamba period: launched {counts}, "
                          f"expected {want}")
    check(all(math.isfinite(v) for v in losses),
          f"train jamba period: losses {losses}")
    check(not torch.equal(probe[0, :4, :4], before),
          "train jamba period: the params did not move")
    steady = statistics.median(walls[1:])
    log(f"train jamba period ({cfg.name} cut to {cfg.n_layers} layers, "
        f"MoE off, bf16 params, grads and moments): {n_params} params, "
        f"{state_bytes / 2**30:.1f} GiB of params, grads and moments; "
        f"{steps} train_steps at (B, S) = ({b}, {s}): losses "
        f"{', '.join(f'{v:.4f}' for v in losses)}; step {walls[0]:.1f} ms "
        f"first, {steady:.1f} ms median of the rest "
        f"({b * s / steady * 1e3:.1f} tokens/s); peak "
        f"{peak / 2**30:.2f} GiB allocated of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}"
        f" GiB; launched {counts} ({2 * n_mamba} forward and {n_mamba} "
        f"backward scans a step); on {card}")
    batch = {k: v.cuda() for k, v in data[steps].items()}
    rows, busy, wall_ms = device_profile(
        lambda: api.train_step(cfg, opt, state, batch))
    check(busy > 0, "the profiler saw no device time in the train step")
    for dev, key, count in sorted(rows, reverse=True)[:10]:
        log(f"train profile jamba period step: {dev:11.1f} us device "
            f"x{count:<5d} ({dev / busy:.4f}) {key[:70]}")
    scans = {k: sum(r[0] for r in rows if k in r[1])
             for k in ("selective_scan_kernel", "selective_scan_bwd_kernel",
                       "scan_bwd_reduce")}
    log(f"train profile jamba period step: device busy {busy / 1e3:.1f} ms "
        f"in {sum(r[2] for r in rows)} kernels: {busy / 1e3 / wall_ms:.3f} "
        f"of the {wall_ms:.1f} ms profiled step, {busy / 1e3 / steady:.3f} "
        f"of the unprofiled median ({steady:.1f} ms); "
        + ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in scans.items()))
    del state, batch, probe
    torch.cuda.empty_cache()
    return counts["selective_scan_bwd"]


def device_profile(fn):
    """One call of ``fn`` under ``torch.profiler``, the card synchronized
    around it: (rows (device us, name, count) of the kernels and copies,
    their device us in all, the call's wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total",
                      getattr(ev, "self_cuda_time_total", 0.0))
        # "Command Buffer Full" is CUPTI's record of the launch queue
        # being full, not a kernel
        if dev > 0 and not ev.key.startswith(("aten::", "Activity",
                                              "Command Buffer Full")):
            rows.append((dev, ev.key, ev.count))
    return rows, sum(r[0] for r in rows), wall_ms


def resume_checks(card):
    """(e): the reference integration test's resume case on the card: a
    gold run, a run that fails at TRAIN_FAIL_AT (exit code 17), its
    relaunch ("resuming at 17"); the final losses within RESUME_TOL."""
    import shutil
    import tempfile
    runs = {}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_resume_"))
    try:
        base = ("--arch", TRAIN_LLAMA, *TRAIN_RESUME_ARGS)
        runs["gold"] = run_train(base + ("--ckpt-dir", str(root / "a")))
        runs["crash"] = run_train(base + ("--ckpt-dir", str(root / "b"),
                                          "--simulate-failure",
                                          str(TRAIN_FAIL_AT)))
        runs["resumed"] = run_train(base + ("--ckpt-dir", str(root / "b")))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(runs["gold"][0] == 0 and runs["resumed"][0] == 0,
          f"resume: exit codes {[r[0] for r in runs.values()]}")
    check(runs["crash"][0] == 17, f"resume: the failing run exited "
                                  f"{runs['crash'][0]}, expected 17")
    check("resuming at 17" in runs["resumed"][4],
          "resume: the relaunch did not resume at 17")
    gold, resumed = runs["gold"][1][-1], runs["resumed"][1][-1]
    check(abs(gold - resumed) < RESUME_TOL,
          f"resume: final loss {resumed} vs gold {gold}")
    log(f"train resume ({TRAIN_LLAMA} smoke, {' '.join(TRAIN_RESUME_ARGS)}, "
        f"failure at {TRAIN_FAIL_AT}): exit code 17, relaunch resumed at "
        f"17; final loss {resumed!r} vs uninterrupted {gold!r} "
        f"({'bitwise equal' if gold == resumed else 'not bitwise'}, within "
        f"{RESUME_TOL}); on {card}")


def train_phase(peaks, card, errs):
    """The twentieth slice's path: (a) the scan's backward kernel, (b)
    smoke configs card against CPU, (c) llama3.2-1b through the trainer,
    (d) jamba's period, the main path, (e) resume.  Returns the
    backward's launches on the main path, its row and (c)'s losses."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    row = scan_bwd_checks(peaks, card, errs)
    smoke_train_checks(card)
    losses = llama_train_run(card)
    launches = jamba_train_run(card)
    resume_checks(card)
    log(f"train: phase wall {time.perf_counter() - t0:.1f} s on {card}")
    return launches, row, losses


# ---------------------------------------------------------------------------
# "train mesh": training on a ("data", "model") mesh of logical devices
# ---------------------------------------------------------------------------
def logical(n):
    """``n`` logical devices on the one card."""
    import torch
    return [torch.device("cuda", 0)] * n


def cuda_sync_ms(fn):
    """(result, wall ms) of ``fn()``, the card synchronized around it."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def sharded_equals(placed, whole) -> bool:
    """Every leaf of a sharded tree gathered equals ``whole``'s, bitwise
    (``whole``: a tree of tensors, or another sharded tree)."""
    import torch
    from repro_torch.distributed.sharding import ShardedTensor
    from repro_torch.optim.adamw import tree_leaves
    for a, b in zip(tree_leaves(placed), tree_leaves(whole)):
        b = b.full() if isinstance(b, ShardedTensor) else b
        a = a.full(b.device)
        if a.dtype != b.dtype or not torch.equal(a, b):
            return False
    return True


class _Wide:
    """A module whose ``float32`` is ``float64``, all else delegated."""

    def __init__(self, mod, wide):
        self._mod, self.float32 = mod, wide

    def __getattr__(self, name):
        return getattr(self._mod, name)


def wide_grads(cfg, params, batch, which):
    """The gradients of leaves ``which`` (``tree_leaves`` indices) of a
    dense config's loss in f64 throughout: params and every config dtype
    in f64, the model modules' casts to f32 widened (as
    tests/test_torch_train.py's ``_wide_grads``)."""
    import dataclasses
    import torch
    from repro_torch.models import api, attention, blocks, transformer
    from repro_torch.models.transformer import tree_map
    from repro_torch.optim.adamw import tree_leaves
    wide = dataclasses.replace(cfg, **{f"{k}_dtype": "float64" for k in (
        "param", "compute", "logit", "attn_score")})
    p64 = tree_map(lambda t: t.detach().double(), params)
    leaves = tree_leaves(p64)
    mods = (attention, blocks, transformer)
    saved = [m.torch for m in mods]
    try:
        for m in mods:
            m.torch = _Wide(torch, torch.float64)
        for i in which:
            leaves[i].requires_grad_(True)
        with torch.enable_grad():
            loss, _ = api.loss_fn(wide, p64, batch)
            return list(torch.autograd.grad(loss, [leaves[i]
                                                   for i in which]))
    finally:
        for m, t in zip(mods, saved):
            m.torch = t


def split_on_one_device(cfg, mesh, placed, params, batch, device):
    """``shard_train.loss_and_grads``' loss and model-block gradients of
    ``placed`` (``params`` placed on ``mesh``) computed directly on
    ``device``: each data rank's rows through ``tensor_parallel.
    local_split``'s tree of the whole ``params`` (every model rank on
    the one device), the ranks' gradients taken to their model blocks
    in data-rank order (``block_grads``) and divided by the number of
    ranks, the losses' mean in the same order."""
    import torch
    from repro_torch.distributed import shard_train, tensor_parallel
    from repro_torch.launch.mesh import mesh_axis_sizes
    from repro_torch.models import api
    from repro_torch.optim import adamw
    n, groups = shard_train.row_split(cfg, mesh, batch)
    check(groups is None, f"{cfg.name}: MoE groups {groups} on {mesh}")
    tpd = mesh_axis_sizes(mesh).get("model", 1)
    plans = tensor_parallel.plan_leaves(cfg, mesh, placed)
    tree, leaves = tensor_parallel.local_split(cfg, params, tpd, device)
    flat = [(i, m, t) for i, per in enumerate(leaves)
            for m, t in enumerate(per) if t is not None]
    dtypes = [t.dtype for t in adamw.tree_leaves(params)]
    losses, acc = [], []
    for r in range(n):
        rows = {k: v.narrow(0, r * (v.shape[0] // n),
                            v.shape[0] // n).to(device)
                for k, v in batch.items()}
        with torch.enable_grad():
            for *_, t in flat:
                t.requires_grad_(True)
            loss, _ = api.loss_fn(cfg, tree, rows)
            got = torch.autograd.grad(loss, [t for *_, t in flat],
                                      allow_unused=True)
            for *_, t in flat:
                t.requires_grad_(False)
        per = [[None] * tpd for _ in leaves]
        for (i, m, _), g in zip(flat, got):
            per[i][m] = g
        del got
        tensor_parallel.block_grads(plans, mesh, r, per, acc, dtypes)
        del per
        losses.append(loss.detach())
    if n > 1:
        acc = [[g / n for g in blocks] for blocks in acc]
    total = losses[0]
    for v in losses[1:]:
        total = total + v
    return (total if n == 1 else total / n), acc


def mesh_split_checks(card, cfg, opt, policy, batch):
    """(a): the first (1, 2) step of ``cfg`` in f32 (the CPU tests' bars
    are for f32 arithmetic) through ``build``: loss and every model
    block's gradient bitwise the same split run with both model ranks
    on the card directly (``tensor_parallel.local_split``), and within
    METRIC_TOL, SPLIT_GRAD_TOL and TRAIN_PARAM_TOL (2 lr everywhere) of
    the single-device step: the row-parallel sums reorder additions.  A
    leaf past SPLIT_GRAD_TOL is held by the CPU tests' f64 bar: its
    error against the f64 gradient (``wide_grads``) within
    RWKV_ERR_FACTOR of the single-device step's."""
    import dataclasses
    import torch
    from repro_torch.distributed import shard_train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import build
    from repro_torch.models import api
    from repro_torch.optim import adamw
    f32 = dataclasses.replace(cfg, compute_dtype="float32",
                              logit_dtype="float32")
    mesh = make_host_mesh(1, 2, devices=logical(2))
    make_state, _, _ = build(f32, opt, mesh, policy)
    placed = make_state(SEED)
    (loss, parts, grads), ms = cuda_sync_ms(
        lambda: shard_train.loss_and_grads(f32, mesh, placed.params, batch))
    single = api.init_train_state(f32, opt, SEED, device="cuda")
    rows = {k: v.cuda() for k, v in batch.items()}

    want_loss, want = split_on_one_device(f32, mesh, placed.params,
                                          single.params, batch,
                                          torch.device("cuda", 0))
    check(torch.equal(loss, want_loss) and all(
        torch.equal(a, b) for ga, gb in zip(grads, want)
        for a, b in zip(ga, gb)),
        "train mesh (a): the (1, 2) step's loss or gradients differ from "
        "the same split run on one device")
    del want
    leaves = adamw.tree_leaves(single.params)
    with torch.enable_grad():
        for t in leaves:
            t.requires_grad_(True)
        want_loss, want_parts = api.loss_fn(f32, single.params, rows)
        want = torch.autograd.grad(want_loss, leaves, allow_unused=True)
        want_loss = want_loss.detach()
        want_parts = {k: v.detach() for k, v in want_parts.items()}
        for t in leaves:
            t.requires_grad_(False)
    want = [torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, want)]
    worst, missed = 0.0, []
    whole = shard_train.whole_grads(placed.params, grads, "cuda")
    for i, (got, w) in enumerate(zip(whole, want)):
        atol = SPLIT_GRAD_TOL["atol_rms"] * float(
            w.double().square().mean().sqrt())
        err = float(((got - w).abs() - SPLIT_GRAD_TOL["rtol"] * w.abs())
                    .max())
        worst = max(worst, err / max(atol, 1e-30))
        if err > atol:
            missed.append(i)
        else:
            whole[i] = None
    # where f32 rounding alone moves a gradient past the bar, the bar is
    # test_torch_train's f64 one (its rwkv rule): the split step's error
    # against the f64 gradient within RWKV_ERR_FACTOR of the
    # single-device step's
    ratios = {}
    if missed:
        g64 = wide_grads(f32, single.params, rows, missed)
        for i, g in zip(missed, g64):
            mine = float((whole[i].double() - g).abs().max())
            ref = float((want[i].double() - g).abs().max())
            ratios[i] = mine / max(ref, 1e-300)
            check(mine <= RWKV_ERR_FACTOR * ref,
                  f"train mesh (a): grad {i} {mine} off the f64 gradient, "
                  f"the single-device step's {ref}")
        del g64
    del whole
    placed, m = shard_train.apply_updates(opt, placed, grads)
    m.update(parts, loss=loss)
    del grads
    _, _, want_m = adamw.apply_updates(opt, single.params, want, single.opt)
    want_m.update(want_parts, loss=want_loss)
    for k, v in want_m.items():
        check(abs(float(m[k]) - float(v)) <= METRIC_TOL["atol"]
              + METRIC_TOL["rtol"] * abs(float(v)),
              f"train mesh (a): {k} {float(m[k])!r} against the "
              f"single-device {float(v)!r}")
    lr = float(want_m["lr"])
    moved = 0.0
    for i, (got, w, g) in enumerate(zip(adamw.tree_leaves(placed.params),
                                        adamw.tree_leaves(single.params),
                                        want)):
        d = (got.full("cuda").float() - w.float()).abs()
        moved = max(moved, float(d.max()))
        atol = SPLIT_GRAD_TOL["atol_rms"] * float(
            g.double().square().mean().sqrt())
        settled = g.abs() > atol + SPLIT_GRAD_TOL["rtol"] * g.abs()
        check(float(d.max()) <= 2 * lr and bool(
            (d <= TRAIN_PARAM_TOL["atol"] + TRAIN_PARAM_TOL["rtol"]
             * w.float().abs())[settled].all()),
            f"train mesh (a): param {i} apart past the bar (2 lr "
            f"everywhere, {TRAIN_PARAM_TOL} where the gradient is settled)")
    del want
    log(f"train mesh (a) {TRAIN_LLAMA} in f32, (1, 2) on 2 logical devices: "
        f"loss and every model block's gradient bitwise the same split on "
        f"one device; against the single-device step loss "
        f"{float(m['loss'])!r} vs {float(want_m['loss'])!r}, grad_norm "
        f"{float(m['grad_norm'])!r} vs {float(want_m['grad_norm'])!r} "
        f"(within {METRIC_TOL}), grads within {worst:.3f} of "
        f"{SPLIT_GRAD_TOL} ({len(missed)} of {len(leaves)} leaves past it, "
        f"their error against the f64 gradient {max(ratios.values(), default=0):.3f}"
        f" of the single-device step's at most), params within "
        f"{moved:.3e} (2 lr = "
        f"{2 * lr:.3e}); the split pass {ms:.1f} ms; on {card}")
    del placed, single
    torch.cuda.empty_cache()


def mesh_bitwise_check(card, cfg, opt, mesh, placed, batch):
    """(a): the mesh's first step (``shard_train.loss_and_grads`` of the
    placed state) bitwise ``split_on_one_device``'s: the same split, in
    the trainer's compute dtypes, with the data ranks' sums in the same
    order, run on the card directly."""
    import torch
    from repro_torch.distributed import shard_train
    from repro_torch.models import api
    (loss, _, grads), ms = cuda_sync_ms(
        lambda: shard_train.loss_and_grads(cfg, mesh, placed.params, batch))
    whole = api.init_train_state(cfg, opt, SEED, device="cuda")
    want_loss, want = split_on_one_device(cfg, mesh, placed.params,
                                          whole.params, batch,
                                          torch.device("cuda", 0))
    del whole
    same = [all(torch.equal(a, b) for a, b in zip(ga, gb))
            for ga, gb in zip(grads, want)]
    check(torch.equal(loss, want_loss) and all(same),
          f"train mesh (a) {mesh.devices.shape}: loss {float(loss)!r} vs "
          f"{float(want_loss)!r}, {same.count(False)} leaves' gradients "
          f"differ from the same split run on one device")
    log(f"train mesh (a) {cfg.name} {tuple(mesh.devices.shape)} in "
        f"{cfg.compute_dtype}: the first step's loss {float(loss)!r} and "
        f"every model block's gradient ({len(grads)} leaves) bitwise the "
        f"same split run on one device; the pass {ms:.1f} ms; on {card}")


class mesh_fault:
    """A wrong split, for the controls of the (4, 2) steps' bar: "drop"
    sums only the first model rank's part of every row-parallel output
    (the others' taken as zeros); "kv_swap" gives each model rank the
    next one's ``wk``/``wv`` block (its query heads attend with another
    rank's kv heads)."""

    def __init__(self, kind):
        self.kind = kind

    def __enter__(self):
        from repro_torch.distributed import collectives, tensor_parallel
        if self.kind == "drop":
            mod, name = collectives, "model_sum"
            orig = collectives.model_sum

            def patched(parts, ranks):
                return orig([parts[0]] + [p.detach() * 0 for p in parts[1:]],
                            ranks)
        else:
            mod, name = tensor_parallel, "plan_leaves"
            orig = tensor_parallel.plan_leaves

            def patched(*args, **kwargs):
                plans = orig(*args, **kwargs)
                for p in plans:
                    if p.node is not None and \
                            p.path.rsplit("/", 1)[-1] in ("wk", "wv"):
                        p.pieces = p.pieces[1:] + p.pieces[:1]
                return plans
        self.undo = (mod, name, orig)
        setattr(mod, name, patched)
        return self

    def __exit__(self, *exc):
        setattr(*self.undo)
        return False


def mesh_bar_misses(got, norm, want, want_norm):
    """What of the (4, 2) steps' losses ``got`` and first grad_norm
    ``norm`` is past its bar against the single-device steps': the first
    loss METRIC_TOL, the later ones MESH_BF16_LOSS_RTOL, the grad_norm
    MESH_BF16_NORM_RTOL."""
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        bar = (METRIC_TOL["atol"] + METRIC_TOL["rtol"] * abs(b) if i == 0
               else MESH_BF16_LOSS_RTOL * abs(b))
        if not abs(a - b) <= bar:
            out.append(f"loss {i} {a!r} vs {b!r}, bar {bar:.3e}")
    if not abs(norm - want_norm) <= MESH_BF16_NORM_RTOL * abs(want_norm):
        out.append(f"grad_norm {norm!r} vs {want_norm!r}, rtol "
                   f"{MESH_BF16_NORM_RTOL}")
    return out


def mesh_steps(cfg, opt, mesh, policy, data, steps, seed):
    """(losses, first grad_norm) of ``steps`` steps of the trainer's
    state made from ``seed`` on ``mesh``."""
    from repro_torch.launch.train import build
    make_state, step_fn, _ = build(cfg, opt, mesh, policy)
    st = make_state(seed)
    losses = []
    for i in range(steps):
        st, m = step_fn(st, data[i])
        losses.append(float(m["loss"]))
        if i == 0:
            norm = float(m["grad_norm"])
    return losses, norm


def mesh_bf16_spread(card, seeds=MESH_SPREAD_SEEDS):
    """``python3 chip_smoke.py --mesh-bf16-spread``: the readings
    MESH_BF16_LOSS_RTOL and MESH_BF16_NORM_RTOL are set from.  For each
    seed (the params' and the data's), the three (4, 2) llama3.2-1b
    steps of the "train mesh" phase against the three single-device
    steps: each loss's and the first grad_norm's relative deviation;
    for seed SEED, the same under each ``mesh_fault``.  One JSON line."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig
    cfg = get_config(TRAIN_LLAMA)
    opt = AdamWConfig(lr=3e-4, warmup_steps=max(TRAIN_LLAMA_STEPS // 20, 2),
                      total_steps=TRAIN_LLAMA_STEPS,
                      moment_dtype=cfg.moment_dtype)
    policy = ShardingPolicy(fsdp=cfg.fsdp)
    steps = MESH_TRAIN["steps"]
    mesh = make_host_mesh(4, 2, devices=logical(8))
    out = {"seeds": {}, "faults": {}}

    def deviations(got, norm, want, want_norm):
        return {"loss": [abs(a - b) / abs(b) for a, b in zip(got, want)],
                "grad_norm": abs(norm - want_norm) / abs(want_norm)}

    for seed in seeds:
        data = make_pipeline(cfg.vocab_size, MESH_TRAIN["seq"],
                             MESH_TRAIN["batch"], seed=seed)
        single = api.init_train_state(cfg, opt, seed, device="cuda")
        want = []
        for i in range(steps):
            batch = {k: v.cuda() for k, v in data[i].items()}
            single, m = api.train_step(cfg, opt, single, batch)
            want.append(float(m["loss"]))
            if i == 0:
                want_norm = float(m["grad_norm"])
        del single
        torch.cuda.empty_cache()
        got, norm = mesh_steps(cfg, opt, mesh, policy, data, steps, seed)
        out["seeds"][seed] = deviations(got, norm, want, want_norm)
        log(f"mesh bf16 spread seed {seed}: single-device losses {want}, "
            f"grad_norm {want_norm!r}; (4, 2) losses {got}, grad_norm "
            f"{norm!r}: {out['seeds'][seed]}")
        torch.cuda.empty_cache()
        if seed == SEED:
            for kind in MESH_FAULTS:
                with mesh_fault(kind):
                    got, norm = mesh_steps(cfg, opt, mesh, policy, data,
                                           steps, seed)
                out["faults"][kind] = deviations(got, norm, want, want_norm)
                log(f"mesh bf16 spread seed {seed} under fault {kind}: "
                    f"(4, 2) losses {got}, grad_norm {norm!r}: "
                    f"{out['faults'][kind]}")
                torch.cuda.empty_cache()
    worst = {"loss": max(max(d["loss"]) for d in out["seeds"].values()),
             "grad_norm": max(d["grad_norm"]
                              for d in out["seeds"].values())}
    log(f"mesh bf16 spread: the largest deviations over seeds {list(seeds)}"
        f" {worst}; on {card}")
    print(json.dumps({"mesh_bf16_spread": out, "worst": worst,
                      "card": card}))


def mesh_llama_checks(card, trainer_losses):
    """(a) llama3.2-1b whole through ``launch/train.py::build``, the
    trainer's optimizer, data and seed: ``mesh_split_checks``'s (1, 2)
    step; three single-device steps, then the (4, 2) state's first
    step bitwise the same split on one device (``mesh_bitwise_check``)
    and three (4, 2) steps from the same initial state (the model ranks
    split attention, FFN and vocabulary) within ``mesh_bar_misses``'
    bars, which a wrong split (``mesh_fault("kv_swap")``, run last as
    the control) must miss; (d) the (4, 2) state
    saved, restored under ``elastic_remesh(6, prefer_model=2)``'s (3, 2)
    mesh bitwise, one step there; an (8, 1) step with ``fsdp=True`` (4
    rows do not divide 8: the batch runs whole, so bitwise the
    single-device first step);
    (e) the trainer's first losses (the "train" phase's run (c), a
    (1, 1) mesh) equal the single-device steps'.  Step ms, peak memory,
    save and restore seconds."""
    import math
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.distributed.sharding import (ShardingPolicy,
                                                  state_pspecs, to_shardings)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import build
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.runtime.fault_tolerance import elastic_remesh
    cfg = get_config(TRAIN_LLAMA)
    opt = AdamWConfig(lr=3e-4, warmup_steps=max(TRAIN_LLAMA_STEPS // 20, 2),
                      total_steps=TRAIN_LLAMA_STEPS,
                      moment_dtype=cfg.moment_dtype)
    data = make_pipeline(cfg.vocab_size, MESH_TRAIN["seq"],
                         MESH_TRAIN["batch"], seed=SEED)
    policy = ShardingPolicy(fsdp=cfg.fsdp)
    steps = MESH_TRAIN["steps"]
    gib = 2 ** 30

    # (1, 2): the split step against the single-device step, and bitwise
    # the same split run on one device
    mesh_split_checks(card, cfg, opt, policy, data[0])
    single = api.init_train_state(cfg, opt, SEED, device="cuda")
    losses, single_ms = [], []
    for i in range(steps):
        batch = {k: v.cuda() for k, v in data[i].items()}
        (single, m), ms = cuda_sync_ms(
            lambda: api.train_step(cfg, opt, single, batch))
        losses.append(float(m["loss"]))
        single_ms.append(ms)
        if i == 0:
            first_m = {k: v.clone() for k, v in m.items()}
    batch = {k: v.cuda() for k, v in data[steps].items()}
    single_rows, single_busy, single_wall = device_profile(
        lambda: api.train_step(cfg, opt, single, batch))
    del single, batch
    torch.cuda.empty_cache()
    log(f"train mesh {TRAIN_LLAMA} single-device losses "
        f"{', '.join(repr(v) for v in losses)}, step ms "
        f"{', '.join(f'{v:.1f}' for v in single_ms)}; a profiled fourth "
        f"step: device busy {single_busy / 1e3:.1f} ms in "
        f"{sum(r[2] for r in single_rows)} kernels and copies, "
        f"{single_busy / 1e3 / single_wall:.3f} of {single_wall:.1f} ms; "
        f"on {card}")
    check(trainer_losses[:steps] == losses,
          f"train mesh (e): the trainer's losses {trainer_losses[:steps]} "
          f"(a (1, 1) mesh) differ from the single-device steps' {losses}")
    log(f"train mesh (e): the trainer's first {steps} losses (through the "
        f"(1, 1) mesh) equal the single-device steps' bitwise; on {card}")

    # (4, 2): the first step's loss and gradients bitwise the same split
    # run on one device, then three steps from the same initial state
    mesh42 = make_host_mesh(4, 2, devices=logical(8))
    make_state, step_fn, _ = build(cfg, opt, mesh42, policy)
    st42 = make_state(SEED)
    mesh_bitwise_check(card, cfg, opt, mesh42, st42, data[0])
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    state_gib = torch.cuda.memory_allocated() / gib
    torch.cuda.reset_peak_memory_stats()
    got, mesh_ms = [], []
    for i in range(steps):
        (st42, m), ms = cuda_sync_ms(lambda: step_fn(st42, data[i]))
        got.append(float(m["loss"]))
        mesh_ms.append(ms)
        if i == 0:
            norm = float(m["grad_norm"])
    peak = torch.cuda.max_memory_allocated() / gib
    check(all(math.isfinite(v) for v in got), f"train mesh (4, 2): {got}")
    want_norm = float(first_m["grad_norm"])
    missed = mesh_bar_misses(got, norm, losses, want_norm)
    check(not missed, f"train mesh (4, 2): {missed}")
    log(f"train mesh {TRAIN_LLAMA} (4, 2) on 8 logical devices: losses "
        f"{', '.join(repr(v) for v in got)}, relatively "
        f"{', '.join(f'{abs(a - b) / abs(b):.3e}' for a, b in zip(got, losses))}"
        f" off the single-device steps' (bars: the first METRIC_TOL, "
        f"then rtol {MESH_BF16_LOSS_RTOL}), the first grad_norm {norm!r} "
        f"{abs(norm - want_norm) / want_norm:.3e} off (rtol "
        f"{MESH_BF16_NORM_RTOL}); step ms {', '.join(f'{v:.1f}' for v in mesh_ms)}"
        f" against single-device {', '.join(f'{v:.1f}' for v in single_ms)}"
        f" ({statistics.median(mesh_ms[1:]) / statistics.median(single_ms[1:]):.3f}x"
        f" on the later steps); sharded state {state_gib:.2f} GiB "
        f"allocated, step peak {peak:.2f} GiB; on {card}")
    rows, busy, wall = device_profile(lambda: step_fn(st42, data[steps]))
    check(busy > 0, "the profiler saw no device time in the (4, 2) step")
    for dev, key, count in sorted(rows, reverse=True)[:8]:
        log(f"train mesh profile (4, 2) step: {dev:11.1f} us device "
            f"x{count:<5d} ({dev / busy:.4f}) {key[:70]}")
    log(f"train mesh profile (4, 2) step: device busy {busy / 1e3:.1f} ms "
        f"in {sum(r[2] for r in rows)} kernels and copies, "
        f"{busy / 1e3 / wall:.3f} of the {wall:.1f} ms profiled step")

    # (d) save under (4, 2) (steps + 1 steps taken), restore under the
    # survivors' (3, 2)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        _, save_ms = cuda_sync_ms(lambda: store.save(
            ckdir, steps, st42, extra={"next_step": steps + 2}))
        mesh32 = elastic_remesh(6, prefer_model=2, pool=logical(8))
        check(mesh32.devices.shape == (3, 2),
              f"train mesh (d): elastic_remesh(6) gave {mesh32}")
        target = api.init_train_state_abstract(cfg, opt)
        (st32, extra), restore_ms = cuda_sync_ms(lambda: store.restore(
            ckdir, target, shardings=to_shardings(
                mesh32, state_pspecs(cfg, mesh32, target, policy))))
        size = ckpt_bytes(ckdir)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    check(extra == {"next_step": steps + 2},
          f"train mesh (d): extra {extra}")
    check(sharded_equals(st32, st42), "train mesh (d): the (3, 2) restore "
                                      "differs from the saved (4, 2) state")
    del st42
    torch.cuda.empty_cache()
    _, step_fn, _ = build(cfg, opt, mesh32, policy)
    (st32, m), ms32 = cuda_sync_ms(lambda: step_fn(st32,
                                                  data[steps + 1]))
    check(math.isfinite(float(m["loss"])), f"train mesh (d): {m}")
    log(f"train mesh (d): the (4, 2) state ({size / 1e9:.2f} GB) saved in "
        f"{save_ms / 1e3:.2f} s, restored under elastic_remesh(6, "
        f"prefer_model=2)'s (3, 2) mesh in {restore_ms / 1e3:.2f} s, every "
        f"leaf bitwise, next_step kept; one (3, 2) step {ms32:.1f} ms, loss "
        f"{float(m['loss'])!r}; on {card}")
    del st32
    torch.cuda.empty_cache()

    # (8, 1) with fsdp: the batch's 4 rows do not divide 8 and run whole
    make_state, step_fn, sshard = build(cfg, opt, make_host_mesh(
        8, 1, devices=logical(8)), ShardingPolicy(fsdp=True))
    split = sum(1 for sh in tree_leaves(sshard.params)
                if "data" in str(sh.spec))
    st81 = make_state(SEED)
    torch.cuda.reset_peak_memory_stats()
    (st81, m), ms81 = cuda_sync_ms(lambda: step_fn(st81, data[0]))
    peak81 = torch.cuda.max_memory_allocated() / gib
    check(all(torch.equal(m[k], v) for k, v in first_m.items()),
          f"train mesh (8, 1) fsdp: metrics {m} differ from the "
          f"single-device first step's {first_m}")
    log(f"train mesh {TRAIN_LLAMA} (8, 1) fsdp=True: {split} param leaves "
        f"split over data; one step {ms81:.1f} ms (the 4 rows run whole: "
        f"metrics bitwise the single-device first step's), peak "
        f"{peak81:.2f} GiB; on {card}")
    del st81
    torch.cuda.empty_cache()

    # the control: a wrong split (kv_swap) misses the (4, 2) bars
    with mesh_fault("kv_swap"):
        bad, bad_norm = mesh_steps(cfg, opt, mesh42, policy, data, steps,
                                   SEED)
    missed = mesh_bar_misses(bad, bad_norm, losses, want_norm)
    check(bool(missed), f"train mesh control: the (4, 2) steps with each "
                        f"rank's kv heads taken from the next rank "
                        f"(losses {bad}, grad_norm {bad_norm!r}) pass the "
                        f"bars")
    log(f"train mesh control: the (4, 2) steps with each rank's kv heads "
        f"taken from the next rank miss the bars ({'; '.join(missed)}); "
        f"on {card}")
    torch.cuda.empty_cache()


class ScanWork:
    """A ``kernels.cuda`` work sink: the selective scan's launches by
    logical rank, with their reported work."""

    def __init__(self):
        self.seen = []

    def kernel_begin(self, counter, flops, nbytes, device):
        from repro_torch.distributed import collectives
        self.seen.append((counter, collectives.current_rank(), flops,
                          nbytes))

    def kernel_end(self, counter):
        pass

    def check(self, cfg, rows, seq, n_ranks, counts, what):
        """Each launch's work is that of ``rows`` rows of ``seq`` steps
        on d_inner / 2 channels (the model rank's); each of the first
        ``n_ranks`` positions launches as many: {kernel: launches a
        rank}."""
        from collections import Counter
        from repro_torch.kernels.mamba_scan import scan
        di, ds = cfg.d_inner // 2, cfg.mamba.d_state
        works = {"selective_scan": {scan.fwd_work(rows, seq, di, ds, save)
                                    for save in (True, False)},
                 "selective_scan_bwd": {scan.bwd_work(rows, seq, di, ds, dh)
                                        for dh in (True, False)}}
        for name, rank, flops, nbytes in self.seen:
            check(tuple((flops, nbytes)) in {tuple(w) for w in works[name]},
                  f"{what}: {name} on rank {rank} did ({flops}, {nbytes}), "
                  f"not a rank's d_inner / 2 = {di} channels")
        by = Counter((n, r) for n, r, _, _ in self.seen)
        per = {n: sorted({c for (k, _), c in by.items() if k == n})
               for n in counts}
        ranks = {r for _, r, _, _ in self.seen}
        check(ranks == set(range(n_ranks)) and all(len(v) == 1
                                             for v in per.values())
              and sum(by.values()) == sum(counts.values()),
              f"{what}: scan launches by rank {dict(by)}")
        return {n: v[0] for n, v in per.items()}


def mesh_smoke_checks(card):
    """(b) every smoke config of ``smoke_families`` takes one (4, 2) step
    at (8, 32) on 8 logical devices of the card and of the CPU from the
    same state (RWKV's mixes and the encoder-decoder's cross-attention
    split over the model ranks too): metrics within FAMILY_TOL
    (grad_norm but for rwkv, as the "train" phase), params within 2 lr;
    only jamba launches kernels,
    the scan's forward and backward on each (data, model) rank: its
    data rank's rows, its d_inner / 2 channels (``ScanWork``)."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import shard_train
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import (ShardingPolicy,
                                                  device_put, state_pspecs,
                                                  to_shardings)
    from repro_torch.kernels import cuda
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.models.frontends import make_inputs
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    opt = AdamWConfig(warmup_steps=2, total_steps=10)
    shape = ShapeConfig("mesh_train", 32, 8, "train")
    for label, cfg in smoke_families():
        state0 = api.init_train_state(cfg, opt, SEED, device="cpu")
        out = {}
        for dev in ("cpu", "cuda"):
            mesh = make_host_mesh(4, 2, devices=[dev] * 8)
            placed = device_put(state0, to_shardings(mesh, state_pspecs(
                cfg, mesh, state0, ShardingPolicy())))
            batch = make_inputs(cfg, shape, seed=SEED, abstract=False,
                                device="cpu")
            split = shard_train.row_split(cfg, mesh, batch)
            nodes = {p.node.rsplit("/", 1)[-1] for p in tp.plan_leaves(
                cfg, mesh, placed.params) if p.node is not None}
            want = ({"rwkv_tm", "rwkv_cm"} if "rwkv" in cfg.attn_layout
                    else set()) | ({"cross_attn"} if cfg.family == "encdec"
                                   else set())
            check(want <= nodes, f"train mesh {label}: {want - nodes} run "
                                 f"whole on the first model rank")
            torch.cuda.synchronize()
            cuda.reset_launches()
            sink = ScanWork()
            with cuda.work_sink(sink):
                new, metrics = shard_train.train_step(cfg, opt, placed,
                                                      batch)
            torch.cuda.synchronize()
            out[dev] = (new, metrics, cuda.launch_counts(), split, sink)
        (c_new, c_m, _, split, _), (g_new, g_m, counts, _, sink) = (
            out["cpu"], out["cuda"])
        for k in ("loss", "xent", "aux", "lr") + (
                () if label == RWKV else ("grad_norm",)):
            torch.testing.assert_close(
                g_m[k].cpu(), c_m[k], **FAMILY_TOL,
                msg=lambda m: f"train mesh {label} {k}, card against CPU: "
                              f"{m}")
        lr = float(c_m["lr"])
        worst = 0.0
        for i, (gp, cp) in enumerate(zip(tree_leaves(g_new.params),
                                         tree_leaves(c_new.params))):
            d = float((gp.full("cpu").float() - cp.full().float()).abs()
                      .max())
            worst = max(worst, d)
            check(d <= 2 * lr, f"train mesh {label} param {i} moved "
                               f"{d} apart, more than 2 lr")
        mamba = "mamba" in cfg.attn_layout
        check(set(counts) == ({"selective_scan", "selective_scan_bwd"}
                              if mamba else set())
              and all(n % (2 * split[0]) == 0 for n in counts.values()),
              f"train mesh {label}: launched {counts}")
        if mamba:
            per_rank = sink.check(cfg, 8 // split[0], 32, 2 * split[0],
                                  counts, f"train mesh {label}")
        log(f"train mesh smoke {label} (4, 2), (B, S) = (8, 32): rows over "
            f"{split[0]} data ranks (MoE groups a rank {split[1]}); card == "
            f"CPU (loss {float(g_m['loss']):.6f} vs {float(c_m['loss']):.6f}"
            f", grad_norm {float(g_m['grad_norm']):.6f} vs "
            f"{float(c_m['grad_norm']):.6f}; params within {worst:.3e}); "
            f"launched {counts}"
            + (f", the scan on each of the {2 * split[0]} (data, model) ranks "
               f"{per_rank} on d_inner/2 = {cfg.d_inner // 2} channels"
               if mamba else ""))
    torch.cuda.empty_cache()


def _mesh_case_steps(case):
    """One step of a (arch smoke, (data, model), batch, seq) case on its
    mesh of logical devices of the card and of the CPU from the same
    state: {"cpu"|"cuda": (cfg, mesh, placed state before the step, new
    state, metrics, collective events of the step, step ms wall)}."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import collectives, shard_train
    from repro_torch.distributed.sharding import (ShardingPolicy,
                                                  device_put, state_pspecs,
                                                  to_shardings)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.models.frontends import make_inputs
    from repro_torch.optim.adamw import AdamWConfig
    arch, (dp, tpd), batch, seq = case
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              logit_dtype="float32")
    opt = AdamWConfig(warmup_steps=2, total_steps=10)
    state0 = api.init_train_state(cfg, opt, SEED, device="cpu")
    data = make_inputs(cfg, ShapeConfig("mesh_case", seq, batch, "train"),
                       seed=SEED, abstract=False, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        mesh = make_host_mesh(dp, tpd, devices=[dev] * (dp * tpd))
        placed = device_put(state0, to_shardings(mesh, state_pspecs(
            cfg, mesh, state0, ShardingPolicy())))
        counter = collectives.CollectiveCounter()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with collectives.counting(counter):
            new, metrics = shard_train.train_step(cfg, opt, placed, data)
        torch.cuda.synchronize()
        out[dev] = (cfg, mesh, new, metrics, counter.events,
                    (time.perf_counter() - t0) * 1e3)
    return out


def _mesh_case_close(label, out, keys):
    """Card against CPU: ``keys`` of the metrics within FAMILY_TOL,
    every param within 2 lr; the largest param difference."""
    import torch
    from repro_torch.optim.adamw import tree_leaves
    (_, _, c_new, c_m, _, _), (_, _, g_new, g_m, _, _) = (out["cpu"],
                                                          out["cuda"])
    for k in keys:
        torch.testing.assert_close(
            g_m[k].cpu(), c_m[k], **FAMILY_TOL,
            msg=lambda m: f"train mesh {label} {k}, card against CPU: {m}")
    lr = float(c_m["lr"])
    worst = 0.0
    for i, (gp, cp) in enumerate(zip(tree_leaves(g_new.params),
                                     tree_leaves(c_new.params))):
        d = float((gp.full("cpu").float() - cp.full().float()).abs().max())
        worst = max(worst, d)
        check(d <= 2 * lr, f"train mesh {label} param {i} moved {d} apart, "
                           f"more than 2 lr")
    return worst


def mesh_hidden_check(card):
    """(b) ``MESH_HIDDEN``: grok smoke on (1, 8), whose 4 experts do not
    divide 8, takes one step on 8 logical devices of the card and of the
    CPU from the same state: each model rank computes with its 16 of
    each expert's 128 hidden columns (``tensor_parallel.plan_leaves``),
    no param is all-gathered (over "model" or "data"), metrics within
    FAMILY_TOL, params within 2 lr."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as tp
    arch, (dp, tpd), batch, seq = MESH_HIDDEN
    cfg = get_config(arch, smoke=True)
    check(cfg.moe.n_experts % tpd != 0 and cfg.d_ff % tpd == 0,
          f"train mesh hidden: {arch} smoke on {tpd} model ranks is no "
          f"expert-hidden split")
    out = _mesh_case_steps(MESH_HIDDEN)
    for dev in out:
        cfg, mesh, new = out[dev][:3]
        experts = [p for p in tp.plan_leaves(cfg, mesh, new.params)
                   if "/moe/experts/" in p.path]
        check(experts and all(
            p.node is not None and len(p.blocks) == tpd
            and p.blocks[0][p.dim].stop == cfg.d_ff // tpd
            for p in experts),
            f"train mesh hidden: the experts do not split by hidden "
            f"column: {[(p.path, p.node, p.dim) for p in experts]}")
    worst = _mesh_case_close("hidden", out, ("loss", "xent", "aux", "lr",
                                             "grad_norm"))
    _, _, _, g_m, events, ms = out["cuda"]
    c_m = out["cpu"][3]
    gathers = [e for e in events if e.kind == "all-gather"]
    check(not gathers, f"train mesh hidden: {len(gathers)} params "
                       f"all-gathered")
    log(f"train mesh (b) {arch} smoke on {(dp, tpd)}, (B, S) = ({batch}, "
        f"{seq}): {cfg.moe.n_experts} experts split by hidden column "
        f"({cfg.d_ff // tpd} of {cfg.d_ff} a rank), no param all-gathered; "
        f"card == CPU (loss {float(g_m['loss']):.6f} vs "
        f"{float(c_m['loss']):.6f}, grad_norm {float(g_m['grad_norm']):.6f}"
        f" vs {float(c_m['grad_norm']):.6f}; params within {worst:.3e}); "
        f"step {ms:.1f} ms wall on {card}")
    torch.cuda.empty_cache()


def mesh_rwkv_check(card):
    """(b) ``MESH_RWKV``: rwkv6-3b smoke on (1, 8), whose 4 heads do not
    divide 8, takes one step on 8 logical devices of the card and of the
    CPU from the same state: ranks 1, 3, 5, 7 own one head each, each
    takes the half head's columns another rank stores (collective-
    permutes of exactly those bytes, nothing all-gathered); loss and
    xent within FAMILY_TOL (grad_norm excepted, as the "train" phase
    excepts rwkv's), params within 2 lr."""
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.distributed import tensor_parallel as tp
    arch, (dp, tpd), batch, seq = MESH_RWKV
    out = _mesh_case_steps(MESH_RWKV)
    cfg, mesh, new, g_m, events, ms = out["cuda"]
    H, hs, D = cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size, \
        cfg.d_model
    check(H % tpd != 0 and D % tpd == 0,
          f"train mesh rwkv: {H} heads on {tpd} model ranks divide")
    owners = tp.head_owners(cfg, tpd)
    counter = collectives.CollectiveCounter()
    with collectives.counting(counter):
        tp.rank_params(cfg, new.params, mesh, 0)
    lack = 0
    for m in range(tpd):
        a, b = tp.rwkv_heads(cfg, tpd, m)
        own = max(0, min(b * hs, (m + 1) * D // tpd) - max(a * hs,
                                                            m * D // tpd))
        lack += ((b - a) * hs - own) * D * cfg.n_layers * 4 * 5
    moved = [e for e in counter.events]
    check(moved and all(e.kind == "collective-permute" for e in moved)
          and sum(e.result_bytes for e in moved) == lack,
          f"train mesh rwkv: a pass's params moved "
          f"{sorted({(e.kind, e.result_bytes) for e in moved})}, want "
          f"collective-permutes of {lack} bytes")
    gathers = [e for e in events if e.kind == "all-gather"]
    check(not gathers, f"train mesh rwkv: {len(gathers)} all-gathers in "
                       f"the step")
    worst = _mesh_case_close("rwkv", out, ("loss", "xent", "aux", "lr"))
    c_m = out["cpu"][3]
    log(f"train mesh (b) {arch} smoke on {(dp, tpd)}, (B, S) = ({batch}, "
        f"{seq}): {H} heads of {hs} on {tpd} model ranks (owners {owners}, "
        f"{D // tpd} columns a stored block), the params' moves "
        f"collective-permutes of {lack} bytes, nothing all-gathered; card "
        f"== CPU (loss {float(g_m['loss']):.6f} vs "
        f"{float(c_m['loss']):.6f}, grad_norm {float(g_m['grad_norm']):.6f}"
        f" vs {float(c_m['grad_norm']):.6f}; params within {worst:.3e}); "
        f"step {ms:.1f} ms wall on {card}")
    torch.cuda.empty_cache()


def gpipe_checks(card):
    """(c) ``gpipe_forward`` over 4 logical stages on the card, each 4 of
    llama3.2-1b's blocks at full width in bf16, 8 microbatches of
    (1, 1024): the outputs bitwise the 16 blocks applied in sequence,
    microbatch by microbatch; wall ms of both."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline import gpipe_forward
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.transformer import (apply_groups, init_params,
                                                tree_map)
    n_stages, n_micro, seq = (GPIPE[k] for k in ("stages", "micro", "seq"))
    cfg = dataclasses.replace(get_config(TRAIN_LLAMA), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    blocks = init_params(cfg, SEED, device="cuda")["blocks"]
    per = cfg.n_layers // n_stages
    stacked = tree_map(lambda t: t.reshape(n_stages, per, *t.shape[1:]),
                       blocks)
    positions = torch.arange(seq, device="cuda")[None]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((n_micro, 1, seq, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)

    def stage(p, h):
        return apply_groups(cfg, p, h, positions)[0]

    def sequential():
        outs = []
        for m in range(n_micro):
            h = x[m]
            for r in range(n_stages):
                h = stage(tree_map(lambda t: t[r], stacked), h)
            outs.append(h)
        return torch.stack(outs)

    pipe = gpipe_forward(stage, Mesh(logical(n_stages), ("pipe",)))
    with torch.no_grad():
        want, seq_ms = cuda_sync_ms(sequential)
        got, pipe_ms = cuda_sync_ms(lambda: pipe(stacked, x))
        _, seq_ms2 = cuda_sync_ms(sequential)
        _, pipe_ms2 = cuda_sync_ms(lambda: pipe(stacked, x))
    check(got.shape == want.shape and torch.equal(got, want),
          "train mesh (c): gpipe_forward differs from the blocks in "
          "sequence")
    log(f"train mesh (c): gpipe_forward over {n_stages} logical stages of "
        f"{per} {TRAIN_LLAMA} blocks (bf16, full width), {n_micro} "
        f"microbatches of (1, {seq}): bitwise the {cfg.n_layers} blocks in "
        f"sequence; wall {pipe_ms:.1f}, {pipe_ms2:.1f} ms pipelined against "
        f"{seq_ms:.1f}, {seq_ms2:.1f} ms in sequence; on {card}")
    del blocks, stacked, x, got, want
    torch.cuda.empty_cache()


def train_mesh_phase(card, trainer_losses):
    """Training on a ("data", "model") mesh of logical devices of the one
    card: (a), (d), (e) ``mesh_llama_checks``; (b) ``mesh_smoke_checks``
    and ``mesh_hidden_check``; (c) ``gpipe_checks``."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    mesh_llama_checks(card, trainer_losses)
    mesh_smoke_checks(card)
    mesh_hidden_check(card)
    mesh_rwkv_check(card)
    gpipe_checks(card)
    log(f"train mesh: phase wall {time.perf_counter() - t0:.1f} s on {card}")


# ---------------------------------------------------------------------------
# "dryrun" and "examples"
# ---------------------------------------------------------------------------
def start_dryrun_cells():
    """(a): one ``python -m repro_torch.launch.dryrun`` process a cell of
    ``DRYRUN_CELLS``, all started together (CPU only: meta tensors), in
    a fresh ``experiments/dryrun_torch_smoke``: (out_dir, procs, start).
    They start before "train mesh", which leaves the host's cores
    mostly idle, so that grok's cell (minutes of tracing) overlaps it."""
    import os
    out_dir = ROOT / "experiments" / "dryrun_torch_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("*.json"):
        old.unlink()
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = []
    for arch, shape, mesh, calibrate in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out", str(out_dir),
               "--force"] + ([] if calibrate else ["--no-calibrate"])
        procs.append((f"{arch} {shape}", subprocess.Popen(
            cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return out_dir, procs, t0


def stop_dryrun_cells(procs) -> None:
    for _, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def finish_dryrun_cells(procs, out_dir, t0):
    """Wait for (a)'s processes and check their records: ``ok``, the
    pinned static bytes, olmo's calibration; print trace s, static and
    temp GiB a device against the card's 80 GiB and the roofline at the
    H100's rates."""
    from repro_torch.launch.analysis import H100_HBM_BYTES
    for arch, proc in procs:
        try:
            out, _ = proc.communicate(timeout=max(
                1, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for _, other in procs:
                other.kill()
                other.communicate()
            raise SmokeFailure(f"dryrun (a): {arch} past "
                               f"{DRYRUN_TIMEOUT_S} s")
        for line in out.strip().splitlines():
            log(f"  {line}")
        check(proc.returncode == 0, f"dryrun (a): {arch} exited "
                                    f"{proc.returncode}")
    recs = {}
    for arch, shape, mesh, calibrate in DRYRUN_CELLS:
        rec = json.loads((out_dir / f"{arch}__{shape}__{mesh}.json")
                         .read_text())
        recs[arch, shape] = rec
        check(rec["status"] == "ok", f"dryrun (a): {rec['cell']} "
                                     f"{rec['status']}: {rec.get('error')}")
        check(rec["static_bytes_per_device"] == DRYRUN_STATIC[arch, shape],
              f"dryrun (a): {rec['cell']} static "
              f"{rec['static_bytes_per_device']!r} != "
              f"{DRYRUN_STATIC[arch, shape]!r}")
        m, ro = rec["memory"], rec["roofline"]
        total = m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
        cal = rec["calibration"]
        note = ""
        if calibrate:
            check(cal["n_groups"] is not None and
                  "bytes_extrapolated_minus_full" in cal,
                  f"dryrun (a): {rec['cell']} was not calibrated")
            note = (f"; calibrated over {cal['n_groups']} groups: FLOPs "
                    f"and collective bytes extrapolated == full, bytes "
                    f"{cal['bytes_extrapolated_minus_full']:+.0f} "
                    f"({cal['bytes_extrapolated_minus_full'] / rec['step']['bytes_accessed']:.2e})")
        log(f"dryrun (a) {rec['cell']}: trace {rec['trace_s']} s; a "
            f"device static {m['argument_size_in_bytes'] / 2**30:.2f} GiB + "
            f"temp {m['temp_size_in_bytes'] / 2**30:.2f} GiB = "
            f"{total / 2**30:.2f} GiB against {H100_HBM_BYTES / 2**30:.0f} "
            f"GiB ({'fits' if total <= H100_HBM_BYTES else 'does not fit'}"
            f"; busiest device {rec['busiest_device']['coords']}); "
            f"t_compute {ro['t_compute_s']:.4g} s, t_memory "
            f"{ro['t_memory_s']:.4g} s, t_collective "
            f"{ro['t_collective_s']:.4g} s, dominant {ro['dominant']}, "
            f"fraction {ro['roofline_fraction']:.4g} (H100 SXM rates){note}")
    return recs


def _ground_case(arch, smoke, batch, seq, fsdp, dev):
    """(fn, placed args, mesh, static) of a (2, 2) sharded train step on
    ``dev`` (``meta``: abstract; else seeded values on the card), FSDP
    as ``fsdp`` or the config says."""
    import dataclasses
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.distributed.sharding import (ShardingPolicy,
                                                  state_pspecs, to_shardings)
    from repro_torch.distributed.shard_train import train_step
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.models.frontends import input_specs, make_inputs
    from repro_torch.optim.adamw import AdamWConfig
    cfg = get_config(arch, smoke=smoke)
    if not smoke:
        cfg = dataclasses.replace(cfg, n_layers=GROUND_LAYERS)
    opt = AdamWConfig(moment_dtype=cfg.moment_dtype)
    shape = ShapeConfig(f"train_{batch}x{seq}", seq, batch, "train")
    mesh = make_host_mesh(2, 2, devices=[dev] * 4)
    if dev.type == "meta":
        state, data = (api.init_train_state_abstract(cfg, opt),
                       input_specs(cfg, shape))
    else:
        state = api.init_train_state(cfg, opt, SEED, device=dev)
        data = make_inputs(cfg, shape, seed=SEED, abstract=False, device=dev)
    policy = ShardingPolicy(fsdp=cfg.fsdp or fsdp)
    spec = state_pspecs(cfg, mesh, state, policy)
    placed = dryrun.place((state, data), (to_shardings(mesh, spec), None),
                          mesh)
    del state
    static = dryrun._sharded_bytes(api.init_train_state_abstract(cfg, opt),
                                   spec, mesh)
    return (cfg, shape, mesh, policy, static,
            lambda s, b: train_step(cfg, opt, s, b), placed)


def ground_truth_checks(card, out_dir):
    """(b): the counters around the same sharded step on meta and on the
    card's logical devices: FLOPs, bytes and collective bytes equal rank
    by rank; the card's peak memory against the record's, its
    synchronized step time against the bound."""
    import torch
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.kernels import cuda
    from repro_torch.launch import dryrun
    for arch, smoke, batch, seq, fsdp in GROUND_CASES:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg, shape, mesh, policy, static, fn, placed = _ground_case(
            arch, smoke, batch, seq, fsdp, torch.device("meta"))
        meta = dryrun.count_step(fn, *placed)
        m_meta = dryrun.summarize(meta, mesh, static,
                                  time.perf_counter() - t0)
        del placed
        cfg, shape, mesh, policy, static, fn, placed = _ground_case(
            arch, smoke, batch, seq, fsdp, torch.device("cuda", 0))
        fn(*placed)                                   # warm
        _, step_ms = cuda_sync_ms(lambda: fn(*placed))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launches()
        card_counts = dryrun.count_step(fn, *placed)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launched = cuda.launch_counts()
        m_card = dryrun.summarize(card_counts, mesh, static, step_ms / 1e3)
        ranks = sorted(set(meta.counter.ranks) | set(card_counts.counter.ranks)
                       | {e.rank for e in meta.counter.events},
                       key=lambda r: (r is None, r))
        for r in ranks:
            a, b = meta.summary(r), card_counts.summary(r)
            if (a["bytes_accessed"], a["flops"]) != (b["bytes_accessed"],
                                                      b["flops"]):
                ops_a = meta.counter.ranks[r].by_op
                ops_b = card_counts.counter.ranks[r].by_op
                for op in sorted(set(ops_a) | set(ops_b)):
                    if ops_a[op] != ops_b[op]:
                        log(f"  dryrun (b) {arch} rank {r} {op}: meta "
                            f"{ops_a[op]!r}, card {ops_b[op]!r}")
            for key in ("flops", "bytes_accessed", "kernels"):
                check(a[key] == b[key], f"dryrun (b) {arch} rank {r}: "
                      f"{key} meta {a[key]!r} != card {b[key]!r}")
            check(a["collectives"] == b["collectives"],
                  f"dryrun (b) {arch} rank {r}: collectives meta "
                  f"{a['collectives']} != card {b['collectives']}")
        if arch.startswith("jamba"):
            check(launched.get("selective_scan", 0) > 0
                  and launched.get("selective_scan_bwd", 0) > 0
                  and all(card_counts.summary(r)["kernels"].get(k, 0) > 0
                          for r in range(4) for k in (
                              "selective_scan", "selective_scan_bwd")),
                  f"dryrun (b) {arch}: launches {launched}, by rank "
                  f"{[card_counts.summary(r)['kernels'] for r in range(4)]}")
        else:
            check(not launched, f"dryrun (b) {arch}: launches {launched}")
        note = ""
        if fsdp:
            # per model rank: each FSDP block leaf gathered a group at a
            # time twice (forward, recompute) and its gradient
            # reduce-scattered once, on meta as on the card
            groups = cfg.n_layers
            split = sum(p.per_group for p in tp.plan_leaves(
                cfg, mesh, placed[0].params))
            for r in range(4):
                kinds = [e.kind for e in card_counts.counter.events
                         if e.rank == r]
                check(kinds.count("reduce-scatter") == groups * split
                      and kinds.count("all-gather") >= 2 * groups * split,
                      f"dryrun (b) {arch} fsdp rank {r}: "
                      f"{kinds.count('all-gather')} all-gathers, "
                      f"{kinds.count('reduce-scatter')} reduce-scatters for "
                      f"{split} leaves in {groups} groups")
            est = before + m_meta["memory"]["peak_all_devices_bytes"]
            check(peak <= 1.05 * est + 2**28,
                  f"dryrun (b) {arch} fsdp: card peak {peak} bytes past the "
                  f"record's {est}")
            note = (f"; fsdp: {split} block leaves gathered a group at a time "
                    f"(forward and recompute) and reduce-scattered")
        records = []
        for tag, m in (("meta", m_meta), ("card", m_card)):
            rec = {"cell": f"{cfg.name}__{shape.name}__logical2x2"
                           f"{'_fsdp' if fsdp else ''}__{tag}",
                   "arch": cfg.name, "shape": shape.name,
                   "mesh": "logical2x2", "tag": "baseline"}
            dryrun.ok_record(rec, cfg, shape, mesh, policy, m,
                             dryrun.totals(m), {"n_groups": None})
            (out_dir / f"{rec['cell']}.json").write_text(json.dumps(rec))
            records.append(rec)
        ro = records[0]["roofline"]
        sum_bound = sum(meta.rank_bound_s(r) for r in ranks)
        est = before + m_meta["memory"]["peak_all_devices_bytes"]
        log(f"dryrun (b) {cfg.name} {shape.name} on (2, 2) logical devices: "
            f"FLOPs {m_meta['flops']:.6g}, bytes "
            f"{m_meta['bytes_accessed']:.6g}, collective bytes "
            f"{m_meta['collectives']['total']:.6g} on the busiest device, "
            f"meta == card on all {len(ranks)} ranks; kernels "
            f"{m_card['kernels']} (launched {launched}); card peak "
            f"{peak / 2**30:.3f} GiB ({before / 2**30:.3f} GiB before the "
            f"step) against the record's {est / 2**30:.3f} GiB (state on "
            f"the card + every logical device's peak; a device: argument "
            f"{static / 2**30:.3f} + temp "
            f"{m_meta['memory']['temp_size_in_bytes'] / 2**30:.3f} GiB); "
            f"step {step_ms:.1f} ms synchronized against bound_time_s "
            f"{ro['bound_time_s'] * 1e3:.3f} ms (busiest device, "
            f"{ro['dominant']}) and {sum_bound * 1e3:.3f} ms for every "
            f"logical device's work on the one card{note}; on {card}")
        del placed, meta, card_counts
        torch.cuda.empty_cache()


def _cache_at(caches, path):
    for key in path.split("/"):
        caches = caches[key]
    return caches


def _ground_decode(case, dev):
    """A ``GROUND_DECODES`` case's serving decode step on ``dev``
    (``meta``: abstract; else seeded params, caches and tokens on the
    card): (cfg, shape, mesh, policy, static, fn, placed args, whole
    args)."""
    import dataclasses
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.distributed.sharding import (ShardingPolicy,
                                                  cache_pspecs,
                                                  params_pspecs,
                                                  to_shardings)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.models.transformer import tree_map
    arch, (dp, tpd), batch, seq, pos, path, layout, more = case
    # f32 logits: a bf16 one moves by a bf16 step under reordered sums
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              logit_dtype="float32", **more)
    shape = ShapeConfig(f"decode_{batch}x{seq}", seq, batch, "decode")
    mesh = make_host_mesh(dp, tpd, devices=[dev] * (dp * tpd))
    caches = api.init_decode_caches(cfg, batch, seq, device=dev)
    if dev.type == "meta":
        params = api.init_params_abstract(cfg)
        tokens = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    else:
        params = api.init_params(cfg, SEED, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        caches = tree_map(lambda t: torch.randn(
            t.shape, generator=gen, device=dev).to(t.dtype), caches)
        tokens = torch.randint(0, cfg.vocab_size, (batch, 1),
                               generator=gen, device=dev,
                               dtype=torch.int64).to(torch.int32)
    policy = ShardingPolicy()
    pspec = params_pspecs(cfg, mesh, params, policy)
    cspec = cache_pspecs(cfg, mesh, caches, policy)
    spec = tuple(_cache_at(cspec, path))
    want = {"sequence": (2, "model"), "kv head": (3, "model"),
            "sequence over data": (2, ("data", "model")),
            "whole": (None, None)}[layout]
    check((want[0] is None and "model" not in spec)
          or (want[0] is not None and spec[want[0]] == want[1]),
          f"dryrun (b) decode: {arch} smoke's {path} is not laid out by "
          f"{layout} on {(dp, tpd)}: {spec}")
    placed = dryrun.place((params, caches, {"tokens": tokens}), (
        to_shardings(mesh, pspec), to_shardings(mesh, cspec), None), mesh)
    static = (dryrun._sharded_bytes(params, pspec, mesh)
              + dryrun._sharded_bytes(caches, cspec, mesh))
    return (cfg, shape, mesh, policy, static,
            lambda p, c, b: dryrun.serve_step(cfg, mesh, "decode", p, b,
                                              caches=c, pos=pos),
            placed, (params, caches, tokens))


def ground_decode_check(card, out_dir, case):
    """(b) a ``GROUND_DECODES`` case: the counters around a smoke
    config's decode step on (2, 4), on meta and on the card: FLOPs,
    bytes and collective bytes equal rank by rank; the data ranks'
    logits within FAMILY_TOL of the unsplit ``decode_step`` on the card;
    the checked cache in its layout (a ``SeqSplit`` of sequence blocks,
    a ``Split`` of kv heads, or whole), no all-gather as large as a
    model rank's block of it."""
    import torch
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch import dryrun
    from repro_torch.models import api
    arch, (dp, tpd), batch, seq, pos, path, layout, more = case
    t0 = time.perf_counter()
    cfg, shape, mesh, policy, static, fn, placed, _ = _ground_decode(
        case, torch.device("meta"))
    meta = dryrun.count_step(fn, *placed)
    m_meta = dryrun.summarize(meta, mesh, static, time.perf_counter() - t0)
    del placed
    cfg, shape, mesh, policy, static, fn, placed, whole = _ground_decode(
        case, torch.device("cuda", 0))
    with torch.no_grad():
        fn(*placed)                                   # warm
        _, step_ms = cuda_sync_ms(lambda: fn(*placed))
        card_counts = dryrun.count_step(fn, *placed)
        want, _ = api.decode_step(cfg, *whole, pos)
    torch.cuda.synchronize()
    m_card = dryrun.summarize(card_counts, mesh, static, step_ms / 1e3)
    for r in range(dp * tpd):
        a, b = meta.summary(r), card_counts.summary(r)
        for key in ("flops", "bytes_accessed", "collectives"):
            check(a[key] == b[key], f"dryrun (b) {arch} decode rank {r}: "
                  f"{key} meta {a[key]!r} != card {b[key]!r}")
    outs = card_counts.outputs
    got = torch.cat([o[0] for o in outs])
    torch.testing.assert_close(
        got, want, **FAMILY_TOL,
        msg=lambda m: f"dryrun (b) {arch} decode: split logits against "
                      f"the unsplit step: {m}")
    c = _cache_at(outs[0][1], path)
    kind = {"sequence": tp.SeqSplit, "kv head": tp.Split,
            "sequence over data": tp.SeqSplit, "whole": torch.Tensor}[layout]
    check(type(c) is kind or (layout == "whole" and isinstance(c, kind)),
          f"dryrun (b) {arch} decode: the new {path} is {c!r}")
    blocks = len(c.parts) if isinstance(c, tp.Split) else 1
    check(layout != "sequence over data" or blocks == dp * tpd,
          f"dryrun (b) {arch} decode: {path} in {blocks} blocks")
    blk = c.parts[0] if isinstance(c, tp.Split) else c
    block = blk.numel() * blk.element_size()
    # a data rank's logits are gathered over the vocabulary
    logits = (batch // len(outs)) * cfg.vocab_size * 4
    gathers = [e.result_bytes for e in card_counts.counter.events
               if e.kind == "all-gather"]
    check(layout == "whole" or all(b < block or b == logits
                                   for b in gathers),
          f"dryrun (b) {arch} decode: an all-gather of {max(gathers)} "
          f"bytes, a block of {path} {block}")
    coll = m_meta["collectives"]
    tag = "".join(f"_{k}{v}" for k, v in more.items())
    rec = {"cell": f"{cfg.name}__{shape.name}__logical2x4{tag}__meta",
           "arch": cfg.name, "shape": shape.name, "mesh": "logical2x4",
           "tag": "baseline"}
    dryrun.ok_record(rec, cfg, shape, mesh, policy, m_meta,
                     dryrun.totals(m_meta), {"n_groups": None})
    (out_dir / f"{rec['cell']}.json").write_text(json.dumps(rec))
    log(f"dryrun (b) {cfg.name} {shape.name} decode at position {pos} on "
        f"{(dp, tpd)} logical devices ({path} by {layout}: "
        f"{type(c).__name__}): FLOPs {m_meta['flops']:.6g}, bytes "
        f"{m_meta['bytes_accessed']:.6g}, collective bytes "
        f"{coll['total']:.6g} (all-to-all {coll['all-to-all']:.6g}, "
        f"all-gather {coll['all-gather']:.6g}) on the busiest device, meta "
        f"== card on all {dp * tpd} ranks; logits within FAMILY_TOL of the "
        f"unsplit step (max abs err {float((got - want).abs().max()):.3e});"
        f" largest all-gather {max(gathers)} bytes, {path} {block} bytes "
        f"a rank; step {step_ms:.1f} ms synchronized against bound_time_s "
        f"{rec['roofline']['bound_time_s'] * 1e3:.4f} ms; on {card}")
    del placed, meta, card_counts, whole
    torch.cuda.empty_cache()


def report_check(out_dir):
    """(c): ``launch/report.py`` renders (a)-(b)'s records."""
    import contextlib
    import io
    from repro_torch.launch import report
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report.main(["--dir", str(out_dir)])
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  {line}")
    check("ERROR" not in text, "dryrun (c): the report has an ERROR row")
    check(text.count("| ok |") >= (len(DRYRUN_CELLS) + 2 * len(GROUND_CASES)
                                   + len(GROUND_DECODES)),
          "dryrun (c): the report is missing records")


def run_examples(card):
    """Every ``examples_torch/*.py`` as a subprocess with its defaults
    (on the card), ``EXAMPLES_AT_ONCE`` at a time: exit 0 and its own
    checks; wall seconds printed."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    paths = sorted((ROOT / "examples_torch").glob("*.py"))
    check(len(paths) == 10, f"examples: {len(paths)} files, want 10")
    pending = list(paths)
    running = []
    failed = []
    while pending or running:
        while pending and len(running) < EXAMPLES_AT_ONCE:
            path = pending.pop(0)
            running.append((path, time.perf_counter(), subprocess.Popen(
                [sys.executable, str(path)], env=env, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        path, t0, proc = running.pop(0)
        try:
            out, _ = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for _, _, other in running + [(path, t0, proc)]:
                other.kill()
                other.communicate()
            raise SmokeFailure(f"examples: {path.name} past "
                               f"{EXAMPLE_TIMEOUT_S} s")
        wall = time.perf_counter() - t0
        tail = out.strip().splitlines()[-3:]
        if proc.returncode != 0:
            failed.append(path.name)
            for line in out.strip().splitlines()[-40:]:
                log(f"  {line}")
        log(f"examples: {path.name} exit {proc.returncode} in {wall:.1f} s "
            f"(wall, {EXAMPLES_AT_ONCE} at a time) on {card}; last lines: "
            f"{' | '.join(tail)}")
    check(not failed, f"examples: {failed} failed")


def dryrun_examples_phases(card, out_dir, procs, t0):
    """"dryrun" (a) runs in the background (CPU only, started by
    ``start_dryrun_cells`` at ``t0``), "examples" runs meanwhile on the
    card, then "dryrun" (a)'s checks, (b) and (c)."""
    t1 = time.perf_counter()
    run_examples(card)
    log(f"examples: phase wall {time.perf_counter() - t1:.1f} s")
    finish_dryrun_cells(procs, out_dir, t0)
    log(f"dryrun (a): {time.perf_counter() - t0:.1f} s since the start, "
        f"{time.perf_counter() - t1:.1f} s of it after \"train mesh\"")
    t2 = time.perf_counter()
    ground_truth_checks(card, out_dir)
    for case in GROUND_DECODES:
        ground_decode_check(card, out_dir, case)
    report_check(out_dir)
    log(f"dryrun: (b)-(c) wall {time.perf_counter() - t2:.1f} s; both "
        f"phases {time.perf_counter() - t1:.1f} s on {card}")


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _leaves(tree):
    return (t for _, t in _paths(tree))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch.kernels import cuda
    # full IEEE f32 in the plain versions' and the yardsticks' cuBLAS and
    # cuDNN calls, as the port computes
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. card
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    peaks = peaks_for(card)
    log(f"device {kind}; nvidia-smi: {card}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    if sys.argv[1:] == ["--mesh-bf16-spread"]:
        mesh_bf16_spread(card)
        return 0

    # 2. build
    t0 = time.perf_counter()
    lib = cuda.build(verbose=True)
    cuda.lib()
    log(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")

    # 3. kernels
    shapes = {"block0": ((4, 224, 224, 3), (3, 3, 3, 16)),
              "block1": ((4, 111, 111, 16), (3, 3, 16, 32))}
    gen = torch.Generator().manual_seed(SEED)
    errs = kernel_checks(shapes, gen)
    conv_ragged_checks(gen, errs)
    conv_dtype_checks(gen, errs)
    fused_geometry_checks(torch.Generator().manual_seed(SEED), errs)
    conv3_checks(torch.Generator().manual_seed(SEED), errs)
    activation_checks(gen, errs)
    bf16_elementwise_checks(gen, errs)
    conv4_ragged_checks(shapes, torch.Generator().manual_seed(SEED), errs)
    pool_geometry_checks(torch.Generator().manual_seed(SEED), errs)
    lut_walk_checks(torch.Generator().manual_seed(SEED), errs)

    ladder_kernel_checks(gen, errs)

    # 4. serve
    launches, requests = serve_checks()
    serve_dtype_checks()
    trace = ladder_trace()
    ladder = ladder_serve_checks(trace)
    launches["activation_lut"] = \
        ladder["ladder_chain"][0]["activation_lut"]
    slo_phase(card)
    wide_launches, faults = faults_phase(card, trace, errs)
    launches.update(wide_launches)
    table = calibration_phase(card, trace, requests)
    mesh_phase(card, shapes, errs)
    launches.update(budget_pool_check(gen, errs))
    launches.update(dual_conv_checks(shapes, gen, errs))
    launches.update(matmul_checks(gen, errs))
    lm_table, lm_sites = plan_lm_sweep()
    for name, cells in lm_table.items():
        log(f"lm sites plan {name:<14s} {'  '.join(cells)}")
    check(lm_table == LM_TABLE, f"lm sites plan {lm_table} differs from "
                                f"the reference's {LM_TABLE}")
    log("lm sites: the plan equals the reference's table")
    lm_rng = np.random.default_rng(SEED)
    lm_launches, lm_ops = lm_site_checks(lm_sites, lm_rng, errs)
    lm_launches.update(lm_kernel_checks(lm_ops, lm_rng, errs))
    for name in ("mm_mxu (bf16)", "mm_vpu (int8)", "mm_vpu (bf16)",
                 "mm_dual_shared", "mm_dual_full", "mm_dual_full (f32)",
                 "flash_attention", "flash_decode"):
        launches[name] = lm_launches[name]
    sass_check(lib)

    # 5. times
    rows = timings(shapes, gen, peaks, lib)
    one = torch.zeros(1, device="cuda")
    log(f"time_ms floor: zero_() on a 1-element CUDA tensor "
        f"{time_ms(lambda: one.zero_()) * 1e3:.3f} us on {card}")
    rows.update(lm_timings(lm_ops, peaks, errs))
    del lm_ops
    rows.update(wide_head_dim_times(peaks, errs))
    srv, rounds, walls = served_rate(requests)
    n = rounds * len(requests)
    rates = sorted(n / w for w in walls)
    for name, r in rows.items():
        lib_t = ("-" if r["library_ms"] is None
                 else f"{r['library_ms'] * 1e3:.3f} us")
        if "library" in r:
            lib_t += f" ({r['library']})"
        extra = ""
        if "yardstick" in r:
            extra = (f", yardstick {r['yardstick'][0]} "
                     f"{r['yardstick'][1] * 1e3:.3f} us")
        if "fp32_bound_ms" in r:
            extra += f", FP32-rate bound {r['fp32_bound_ms'] * 1e3:.1f} us"
        if "yardstick2" in r:
            extra += (f", {r['yardstick2'][0]} "
                      f"{r['yardstick2'][1] * 1e3:.1f} us")
        if "grid" in r:
            extra += f", {r['grid']}"
        if "exp_bound_ms" in r:
            extra += (f", exponentials {r['exp_bound_ms'] * 1e3:.1f} us at "
                      f"the MUFU rate")
        if "work_bound_ms" in r:
            extra += (f", the kernel's own operations (S once a column "
                      f"block) {r['work_bound_ms'] * 1e3:.1f} us")
        kern = f" ({KERNEL[name]})" if name in KERNEL else ""
        log(f"{name}{kern} [{r['shape']}]: {r['ms'] * 1e3:.3f} us, plain "
            f"{r['plain_ms'] * 1e3:.1f} us, library {lib_t}{extra}, bound "
            f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}) on {card}")
    log(f"served {statistics.median(rates):.1f} requests/s, median of "
        f"{len(walls)} windows of {n} requests (range {rates[0]:.1f}-"
        f"{rates[-1]:.1f} requests/s, walls "
        f"{', '.join(f'{w:.3f}' for w in walls)} s; 224x224x3, max_batch "
        f"{MAX_BATCH}, fuse=True) on {card}")

    ladder_rates = {}
    for name in LADDER:
        per_window, lwalls = ladder_rate(name, trace)
        lrates = sorted(per_window / w for w in lwalls)
        ladder_rates[name] = statistics.median(lrates)
        log(f"{name}: served {statistics.median(lrates):.1f} requests/s, "
            f"median of {len(lwalls)} windows of {per_window} requests "
            f"(range {lrates[0]:.1f}-{lrates[-1]:.1f} requests/s, walls "
            f"{', '.join(f'{w:.3f}' for w in lwalls)} s; 224x224x3, "
            f"waves of {LADDER_MIX}, max_batch {MAX_BATCH}) on {card}")

    per_window, cwalls = ladder_rate("ladder_fused", trace, table)
    crates = sorted(per_window / w for w in cwalls)
    log(f"ladder_fused with calibration=table ({table.fingerprint()}): "
        f"served {statistics.median(crates):.1f} requests/s, median of "
        f"{len(cwalls)} windows of {per_window} requests (range "
        f"{crates[0]:.1f}-{crates[-1]:.1f} requests/s, walls "
        f"{', '.join(f'{w:.3f}' for w in cwalls)} s), beside the "
        f"analytical ladder_fused's {ladder_rates['ladder_fused']:.1f} on "
        f"{card}")

    log(f"faults: availability guarded {faults['availability'][0]!r}, "
        f"bare {faults['availability'][1]!r}; snapshot_server "
        f"{faults['snapshot_ms']!r} ms, recover_server "
        f"{faults['recover_ms']!r} ms (medians of {RECOVERY_REPS}), "
        f"checkpoint {faults['ckpt_bytes']} bytes, "
        f"{faults['plans_imported']} plans imported, 0 cold plans; on "
        f"{card}")

    launches["selective_scan"], rows["selective_scan"] = lm_serve_phase(
        peaks, card, errs)
    lm_families_phase(peaks, card)
    launches["selective_scan_bwd"], rows["selective_scan_bwd"], losses = \
        train_phase(peaks, card, errs)
    out_dir, procs, t0 = start_dryrun_cells()
    try:
        train_mesh_phase(card, losses)
        dryrun_examples_phases(card, out_dir, procs, t0)
    finally:
        stop_dryrun_cells(procs)

    kernels = [{"name": name, "route": "cuda", "source": SOURCE[name],
                "kernel": KERNEL[name],
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": errs[name], "ms": rows[name]["ms"],
                "plain_ms": rows[name]["plain_ms"],
                "bound_ms": rows[name]["bound_ms"],
                "bound_by": rows[name]["bound_by"],
                "library_ms": rows[name]["library_ms"]}
               for name in REPLACES]
    profile_serving(srv, requests, rounds, statistics.median(walls))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
