#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

(``tools/ring_matmul_bench.py`` and ``tools/ring_matmul_ss_bench.py`` time
ring_matmul and ring_matmul_ss alone, with this script's shapes and
timing, for another checkout's kernel or a variant;
``tools/bitpack_bench.py`` times unpack and pack at every main-path shape
of the word-route and the bit-route triple merge; ``tools/gmw_bench.py``
times the adders' kernels at every main-path shape, and the online wall.)

Phases (any failure raises, and the script exits non-zero):

1. device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them; turn TF32 off for the plaintext reference forward;
2. build: compile the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, in parallel) and print the build time;
3. kernels: call each kernel's wrapper on CUDA tensors at the shapes the
   main path gives it (the stem's ReLU, 4 requests merged), require it to
   equal its plain PyTorch version exactly, and time both with CUDA
   events (median over trials); beaver_and in both forms (plain, and
   opening the exchanged (d, e) itself, as the dense adder's initial AND
   runs it); cone_step at the stem's initial round and first level and
   at w = 8's last level (the sign plane), each beside its bound
   (``cone_step_bytes``); ring_matmul at all 12 (M, K, N) the main
   path gives it, with full-range int32 weights, and its sum per main-path
   call (launches x ms) beside the card's bound; read the ring_matmul and
   ring_matmul_ss kernels' tensor-core (IMMA) and IMAD counts from their
   SASS and their registers and spills from ptxas; unpack at the four sign-plane shapes
   (``SIGN_PLANES``) with its sum per main-path call beside the bound,
   at the ragged merge's shape and at w = 8 and 32; pack_ring with the A2B
   mask (the main path's form) at its seven main-path shapes
   (``PACK_RING_SHAPES``) with its sum per main-path call beside the
   bound, and unmasked at the stem's (64, 0) and (21, 13); then the LM
   paths' shapes, read from their plans (``lm_shape_launches``: the short
   path's two, the long path's two): the dense adder (beaver_and in both
   forms, ks_mask, ks_combine, ks_step at every level's shift) at each
   plan's widths (64, 22, 16) over each of its word counts (the streams'
   merged E / 32: 64 and 46 464 on the short path, 131 072 and 1 486 848
   on the long one), pack_ring (masked) at each (k, m, E), unpack at each
   sign plane, ring_matmul at each projection and the lm_head (M = 2
   parties x the tokens: 16 and 1 024) and ring_matmul_ss (the secret x
   secret ring matmul) at each product, in the form its M picks (the large
   ``wgmma`` form at the long path's QK^T, A@V and their Beaver combines,
   one launch of it counted), each kernel's sum per LM call beside its
   bound; ring_matmul_ss also at K = 16 512, past its 4096 split
   (``RING_MATMUL_SS_OTHER_SHAPES``), with 36 x ``torch._int_mm`` as a
   yardstick where that takes the shape.  A function whose one call takes
   more than ``LONG_CALL_MS`` is timed over fewer trials and repeats, and
   a plain version slower than ``SLOW_PLAIN_MS`` by one warm call;
4. main path: full-width ResNet-18 (widths 64-128-256-512, 32x32 input,
   10 classes, seeded random weights at the reference's init scales), 4
   requests as sibling streams through ``api.compile`` and
   ``PrivateModel.__call__``, under four plans: exact, reduced ((k, m) =
   (21, 13) on every ReLU group but the last, which is culled), and the
   same two with the MSB-cone-pruned adder (``cone=True``).  Per plan:
   offline, the session's triple pool for one call (``Session.offline``,
   4 streams; until PR 30 one call's triples for each of the 1 +
   ``ONLINE_CALLS`` calls) is generated before any timer (its wall and
   device bytes printed) and rolled back before every call, each call
   with its own request key; then each call runs twice on the same
   key and triples (the pool rolled back between them): on the generator
   loop (``HB_ROUND_LOOP=python``) and on the captured replay (``scan``,
   one CUDA graph per stream signature); one untimed warm-up pair (the
   replay's first call runs the generator loop and captures), then
   ``ONLINE_CALLS`` timed pairs (median, min, max per loop).  Launch
   counters are zeroed just before each call and read just after; each
   eager call must launch exactly the kernels of its path
   (``PATH_KERNELS``), pack_ring once per ReLU, every launch with the A2B
   mask, unpack once per ReLU (the sign plane) and the adders' kernels as
   often as their levels say (``adder_launches``: the cone adder one
   cone_step per round).  Each replay must give the eager call's shares,
   launch nothing from the host, hold in its graph the eager call's
   launches, and leave the previous replay's result as it was.  Every
   call's fused rounds and bytes must equal ``plan.schedule(streams=4)``;
   the exact plans' revealed logits must match the plaintext forward
   within the stated tolerance.  Then, per plan, the replay's input refill
   (device ms and launches) and the eager key split are timed, and one
   replay runs under torch.profiler (its device-busy share, and its
   kernels counted by name against its capture) and one under cProfile
   (the host's time by function); one exact call on the generator loop
   is profiled too;
5. LM path: Qwen1.5-0.5B at full width (``qwen1.5-0.5b``: d_model 1024,
   16 heads, d_ff 2816, vocab 151 936, QKV bias, gated SiLU MLP), depth cut
   to ``LM_LAYERS`` = 2, seeded random float32 weights, ``LM_STREAMS`` = 2
   requests of ``LM_SEQ`` = 8 embedded tokens (hidden states N(0, 1) x 0.5)
   as sibling streams through ``api.compile`` and ``PrivateModel.__call__``,
   under two plans: exact (every ReLU group (64, 0)) and reduced ((22, 0)
   on the attention-score groups, (22, 6) on the PWL groups).  Per plan:
   one untimed warm-up call, then ``ONLINE_CALLS`` timed calls, each after
   its own ReLU triple pool from ``Session.offline(requests=1)`` made
   before the timer (product triples stay inline, as in the reference),
   on the generator loop (a plan with
   Beaver opens never runs on the captured replay); every call's rounds
   and bytes equal to ``plan.schedule(streams=2)`` and to ``LM_SCHEDULE``,
   exactly the path's kernels (``PATH_KERNELS``) as often as its plan
   says (``lm_shape_launches``), the exact plan's logits within the tolerance
   of the plaintext twin (``lm.mpc_reference``, float32 on the card); then
   the last call again with ``HB_ROUND_LOOP=scan`` (pool rolled back) must
   give the same shares and capture nothing, and one call runs under
   torch.profiler (busy share, top device ops); then each of the path's
   ReLU calls at full width (one per (k, m, n) of either plan:
   ``gmw.relu_many`` on the 2 streams) must launch exactly the ReLU's
   kernels and equal the same call on the CPU bit for bit
   (``lm_relu_phase``: the reduced plan's logits are only reported); then
   the long LM path (``lm_long``, ``lm_long_setups``): the same model and
   plans, one request of ``LM_LONG_SEQ`` = 512 tokens, the exact plan at
   depth 1 and the reduced one at depth 2 (``LM_LONG_LAYERS``: an exact
   call's ReLU triples take 37.3 GB a layer), through the same calls and
   checks, each pool freed before the next is made: every call's rounds
   and bytes equal to ``plan.schedule(streams=1)`` and ``LM_SCHEDULE``,
   every kernel launched as often as the plan says, ring_matmul_ss every
   time in its large form (``ops.ring_matmul_ss.large``), the exact plan's
   logits within the short path's tolerance, scan == python; each plan's
   pool bytes, offline seconds per call, peak allocated memory, and one
   call under torch.profiler (busy share, top device ops);
6. ragged merge: ``gmw.relu_many`` on 4 sibling streams of 8209 elements
   (not a multiple of 32, so their triples merge at the bit level, through
   unpack and pack), dense at (64, 0) and with the cone at (21, 13), each
   launching exactly its ``PATH_KERNELS`` and equal bit for bit to the
   same call on the CPU with the plain versions;
7. merge: ``beaver.concat_relu_triples`` on the stem's 4 streams (exact,
   dense and cone) by the word route and by the bit route (the ragged
   case's), timed both ways and required ``torch.equal``;
8. stem breakdown: the exact plan's stem layer for 4 requests timed by
   part (conv; the triples' offline generation into a pool; the online
   protocol from the pool; the adder dense and cone-pruned), and the
   device's busy share of one traced online run of it (conv + protocol);
9. search: the paper's §4.1 on full-width ResNet-18, as
   ``examples/private_inference.py`` runs it (``search_phase``): 512
   synthetic images on the card, ``finetune`` with the exact config,
   ``search_eco`` (its accuracy equal to the baseline) and the 8/64
   ``search_budget`` over widths (6, 8) (its config within the budget),
   one candidate's evaluation profiled, ``simulated_hb_relu`` on the card
   equal to the CPU at the stem's activations; then the budget search's
   plan served to 4 requests through ``online_calls`` (every call's rounds
   and bytes equal to ``plan.schedule(streams=4)`` and to the search's
   ``objective_value``, exactly the plan's launches per kernel,
   ``resnet_shape_launches``), and each ReLU kernel against its plain
   version at the plan's own shapes (``search_kernel_phase``), with its
   sum per call;
10. serve: the ``InferenceEngine`` over full-width ResNet-18's reduced plan
   (``BatchPolicy(max_batch=4)``, three tenants, the default inline
   triples, the captured replay): ``SERVE_MIX`` (8 single images with
   explicit ids, one of batch 2, one with ``deadline_s=0``; carol's budget
   holds one request) drained, then ``SERVE_WARM``; the batches must be
   ``SERVE_BATCHES`` (three stream signatures), each batch's rounds and
   bytes equal to ``simulate_merged``'s prediction and its rounds to the
   max over its requests; the over-budget request must fail with
   ``TripleBudgetExceeded`` and the late one with ``DeadlineExceeded``;
   every request's shares must equal its serial oracle on the card; each
   batch must launch its requests' kernels as their plans say
   (``resnet_shape_launches`` per request, unmerged), twice on a
   signature's first batch (generator loop, then capture), none from the
   host on a warm one (its graph holds them); each ReLU kernel equal to
   its plain version at the serving shapes; per batch its requests,
   rounds, bytes, synchronized wall, first call plus capture against warm,
   and the replay cache's entries, captures and reserved memory printed;
11. serve-lm: the private LM through an engine built with ``apply_fn=None``
   on the exact plan: 2 requests as one batch on the generator loop,
   rounds and bytes equal to the engine's merged schedule (opens merged
   per site) and ``LM_SCHEDULE``'s 46 rounds, the plan's kernels, the
   logits within the exact plan's tolerance;
12. frontend: ``Frontend.serve_background`` on a ResNet engine
   (``max_batch=1``) with a fresh replay cache, 6 concurrent ``POST
   /infer`` from threads, batch 1 and 2 in turn, captures made while they
   run; every reply equal to the same request id on a direct engine, no
   pump error, every wait bounded;
13. seed-oracle: ``gmw_ref.relu`` (the frozen seed path, which launches
   only ``beaver_and``) against ``gmw.relu`` at the stem's shape at (64,
   0), (21, 13) and (21, 13) with the cone, bit for bit, both paths'
   exchanges and walls printed; ``BENCH_relu.json``'s ``multigroup``
   through both (31 swaps against 10 rounds, 696 576 B each, same shares);
14. deploy: full-width ResNet-18 as two parties, each holding only its
   own share rows (local party dimension 1), on one input of batch 4
   under the exact and reduced plans (one call's triple pool each, made
   offline and sliced per party; the oracle is the ``SimComm`` generator
   loop on the card with the same shares, pool and key, its launches equal
   to one party's as the plan counts them): (a) ``Session.resilient`` with
   a seeded ``FaultPlan`` (2 drops, 2 corruptions) on ``SimComm``, reduced:
   shares equal, every event recovered, framed rounds and bytes equal to
   ``Schedule.framed()``; (b) both parties as threads over localhost
   ``Session.connect``, exact and reduced: shares equal, each party's
   socket and ``ResilientComm`` rounds and bytes equal to the framed
   schedule, every path kernel launched twice one party's count (counters
   zeroed just before, ``launches_by_path["deploy"]``); each party's wall
   beside the SimComm call's, unshaped and paced by ``LinkShaper`` to the
   LAN preset (within ``Schedule.wall_band``); (c) two ``python -m
   repro_torch.launch.party_host`` processes over a ``write_job``
   directory (reduced): a clean run, then party 0 killed after round
   ``DEPLOY_DIE_AFTER`` with journals (exits 42 and 17) and both relaunched
   (resumed at that round, ``replayed`` equal to it), shares equal each
   time, the journal bytes written printed; (d) a leader
   ``InferenceEngine`` with ``EngineLink`` and a ``serve_follower`` thread
   serve 3 single images from 2 tenants (per-tenant ``StreamingTTP``
   triples sliced per party), each equal to the SimComm engine's serial
   run; then each ReLU kernel (the opening forms for party 0 and party 1)
   and ring_matmul at P = 1 against its plain version at every shape of
   the deploy path, the stem's timed;
15. examples: the port's twins of the reference's five user scripts
   (``tools/quickstart.py``, ``api_smoke.py``, ``serving_engine.py``,
   ``private_inference.py``, ``two_party_serving.py``; ``RESNET_SMOKE``,
   as the reference's), each at its defaults on the card, on the users'
   round loop (the captured replay): the first four in this process
   through ``main([])``, two_party_serving as its own process tree (the
   twin, a ``party_host --follow`` process and a ``serve.frontend``
   process, all with ``--device cuda``, on a job written here; the group
   killed after ``EXAMPLES_WAIT_S``): every twin finishes; each twin's
   launches equal kernel by kernel what the plans it ran price
   (``examples_shape_launches``: ``resnet_shape_launches`` with
   ``resnet_matmul_shapes`` at each plan's input; every compiled call its
   signature's first, counted for the call and its capture); every
   served batch's measured rounds equal the predicted ones; quickstart,
   api_smoke, serving_engine and two_party_serving (on the same job) run
   again on the host's CPU and must return the same shares, reveals,
   replies, rounds, usage and Gantt chart bit for bit; each kernel equals
   its plain version at every shape the twins launch it at (P = 2 for the
   in-process twins, P = 1 in both opening forms for the parties,
   ring_matmul at every M); launch counters zeroed just before each
   in-process twin and read just after, the leader process's read from
   its ``/stats`` (``launches_by_path["examples"]``); each twin's output
   goes to ``chiprun_out/examples/``. The walls are of the smoke preset
   and say nothing of the port's speed;
16. mesh: two-party device execution (``launch.mesh``, ``MeshComm``, the
   mesh-native ``jit_step``) on the deploy phase's setup and against its
   ``SimComm`` oracle: (a) the smoke mesh (1, 1) in this process,
   ``jit_step`` without and with the data axis (``shard_pool(pool, 1)``),
   each once on the captured replay (timed beside the replay's; its
   counters equal to the schedule round for round) and once on the
   generator loop (its census equal to the schedule round for round):
   shares equal; (b)
   the party axis of size 2 as two ranks spawned on the one card
   (``spawn_local``: ``spawn`` start method, ``torch.cuda.set_device(0)``,
   a gloo group, every round staged through pinned host memory): exact and
   reduced, one untimed call of each plan on every rank, then
   ``MESH_CALLS`` timed calls each: each rank's census equal to the
   schedule, rank 0's gathered shares equal to the oracle's, each party's
   median wall (beside the deploy phase's socket parties' from this run),
   rank 0's launches as the plan counts them for one party (zeroed just
   before each timed call, read just after; ``launches_by_path["mesh"]``);
   (c) the (2, 2) mesh as
   four ranks, reduced: each shard's census equal to the schedule of the
   plan traced at batch 2, its shares to the ``SimComm`` step on its rows
   with ``TriplePool.shard``'s pool, the gathered reveal within 2^(13-16)
   + 1e-4 of the unsharded call's; (d) (b)'s two ranks, their gloo group
   left, asking for an NCCL mesh on the one card: ``make_mpc_mesh`` must
   refuse them (its message and NCCL's own printed); then each ReLU kernel at a data shard's P = 1
   shapes and ring_matmul at the smoke mesh's rows, against their plain
   versions (records on path "mesh").  Every spawned run is bounded
   (``MESH_WAIT_S``); the kernels are built here before any rank starts,
   and ranks only load them;
17. analysis: the protocol-safety gate (``repro_torch.analysis``): lint
   R001-R006 and the lock checks (L001, L002) over the port's files, the
   number of findings printed, none outside
   ``tools/hbcheck_torch_baseline.json`` allowed; then the leakage census
   over the comm seam on the deploy phase's setup (full-width ResNet-18,
   one input of batch 4, exact and reduced, the ``SimComm`` generator
   loop's ``serve_step``): each plan's call run as given, with fresh input
   shares, and with a fresh pool and key (one more such run only if an
   element is suspect), every wire element classed; zero unmasked rounds,
   the input moving from round 1 on (round 0 holds the A2B masks), and
   rounds and bytes equal to the schedule round for round and to
   ``ANALYSIS_SCHEDULE`` (170 / 552 599 552 B, 91 / 98 566 144 B a party);
   each plan's rounds by class printed.  The first run's payloads stay on
   the card (about 1.1 GB for exact);
18. zoo: the plaintext model zoo's serving path (``launch.serve``'s
   ``make_prefill_step``, ``greedy_decode_loop`` and ``make_decode_step``
   over ``models.lm`` / ``models.encdec``; plain torch ops, none of the
   port's kernels, which the phase checks), seeded weights (``zoo_phase``):
   (a) Qwen1.5-0.5B at full width and depth in bfloat16, 4 requests of 128
   tokens prefilled, 32 tokens decoded greedily: prefill wall, the loop's
   wall and tokens/s, the median synchronized decode step, one decode step
   under torch.profiler (busy share, device ops), parameter and cache
   bytes; (b) the same model in float32 on 1 request of 32 tokens and 8
   decode steps, on the card and on the host's CPU: logits within
   ``ZOO_F32_TOL``, greedy tokens equal, decode equal to ``apply`` on the
   fed tokens within ``tests/test_archs_smoke.py``'s tolerance; (c) the
   nine other architectures at full width, depth cut (``ZOO_DEPTH``),
   bfloat16: 2 requests of 64 tokens (seamless: 64 stub frames; internvl2:
   256 stub vision tokens before them), 4 decode steps, finite logits of
   the reference's shapes, decode against ``apply`` reported, and for the
   dense and SSM families required on a float32 copy of the same weights.
   Each time is printed beside the card's name and power limit;
19. train: the training path (``launch.train``'s ``make_train_step`` over
   ``models.lm`` under autograd with the config's per-layer remat,
   ``train.optimizer``'s AdamW, ``data.TokenPipeline``, ``train.loop``;
   plain torch ops, none of the port's kernels, which the phase checks),
   seeded weights (``train_phase``): (a) Qwen1.5-0.5B at full width and
   depth (619 446 272 params, float32 masters, bfloat16 compute, remat
   "dots"), ``TRAIN_SHAPE`` = 4 x 512 tokens a step: one warm-up step,
   then ``TRAIN_STEPS`` synchronized steps (losses finite; median wall,
   tokens/s, peak memory), one step under torch.profiler (busy share,
   device ops) and one under cProfile (host time by function), the
   model-FLOP fraction of the median step (6·N·D
   against ``runtime.roofline``'s 989.4 TFLOP/s) and ``op_analyzer``'s
   FLOPs of one step beside 6·N·D, one step each under remat "none" and
   "full" (wall, peak memory); (b) the same step twice from one state
   under ``torch.use_deterministic_algorithms(True)``: params, moments and
   loss bitwise equal; (c) the same model at depth 2 in float32 (TF32
   off), 2 x 64 tokens, one loss and gradient on the card and on the
   host's CPU: the loss within ``TRAIN_LOSS_RTOL``, every gradient leaf
   within ``TRAIN_GRAD_REL`` of its largest CPU magnitude; then one step
   with 2 microbatches against 1 on the card (``tests/test_system.py``'s
   tolerance); (d) the reference's restart test on the card: the
   ``-smoke`` model at 2 layers trained 8 steps straight, and again with a
   checkpoint at 4 and a failure injected at 6 then resumed (from 4):
   params bitwise equal; the card's checkpoint restored onto the CPU
   bitwise equal too;
20. dryrun: the dry run (``launch.dryrun``: the partition rules as DTensor
   placements, the in-model constraints, a fake process group, fake
   tensors on the card's device type; nothing allocated, nothing moved),
   four ``python -m repro_torch.launch.dryrun`` processes at once
   (``dryrun_phase``): (a) the train phase's own setup (Qwen1.5-0.5B, 4 x
   512 tokens, remat "dots", AdamW) on a one-card mesh, passed as a
   ShapeConfig of its own: its FLOPs within ``DRYRUN_FLOPS_RTOL`` of the
   train phase's ``op_analyzer`` count and its ``peak_bytes`` within
   ``DRYRUN_PEAK_RTOL`` of the train phase's measured peak, both printed;
   (b) Qwen1.5-0.5B train_4k on the (16, 16) fake mesh of 256 ranks at
   depth ``DRYRUN_MESH_DEPTH``: status ok, per-card FLOPs and
   collectives; (c) the private LM's MPC cell (Qwen1.5-0.5B, 8/64) and (d)
   ResNet-18's MPC cell on the (party 2, data 256) mesh at 8/64: rounds
   and bytes equal to ``plan.schedule()``; zero launches of the port's
   kernels in every process.

Each phase's seconds are printed (``phase <name>: ...``) and recorded.
Output: a ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``.  The full record also goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time

# cuBLAS is bitwise reproducible only with a fixed workspace, which must be
# set before CUDA initialises (the train phase's determinism check)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# ring_matmul's least work: 26 int8 digit-plane products, 2 operations per
# multiply-add, on the int8 tensor cores.  x has 8 byte digits and w at
# least 4 (bytes 0-2 u8, byte 3 s8), and only shifts i + j < 8 count:
# 8 + 7 + 6 + 5.  The kernel issues 30 (w as 5 balanced s8 digits; design
# note in csrc/ring_matmul.cu).
PLANE_PRODUCTS = 26
ISSUED_PLANE_PRODUCTS = 30
# ring_matmul_ss: both operands' 8 raw bytes, shifts i + j < 8
SS_PLANE_PRODUCTS = 36

STREAMS = 4
# ResNet-18's ReLUs by group: elements per request and ReLUs per call (the
# stem, then 4 in each stage), and each plan's width per group (0: culled)
RELU_GROUPS = ((65536, 1), (65536, 4), (32768, 4), (16384, 4), (8192, 4))
PLAN_WIDTHS = {"exact": (64,) * 5, "reduced": (8,) * 4 + (0,)}
PLAN_WIDTHS.update({f"{p}-cone": ws for p, ws in PLAN_WIDTHS.items()})
# each plan width's ring bits (k, m), as ``resnet_setup`` builds the plans
RING_BITS = {64: (64, 0), 8: (21, 13)}
# the sign plane's unpack: (2 parties, w = 1, n = 4 requests' elements)
SIGN_PLANES = tuple(sorted({STREAMS * n for n, _ in RELU_GROUPS}, reverse=True))
# the ragged-merge path's elements per stream: not a multiple of 32
RAGGED_N = 8209
# the kernels each run must launch, and no others: pack_ring (masked: the
# A2B round's v ^ r) and unpack (the sign plane) on every ReLU,
# ring_matmul on every conv and fc; the dense adder runs on beaver_and
# (its initial AND), ks_mask (its first level), ks_step (one per level
# after the first) and ks_combine (its last level), the cone adder on
# cone_step alone (one per round).  Every ResNet-18 group's element count
# is a multiple of 32, so the 4 streams' triples merge by word
# concatenation; the ragged-merge path's are not, and its merges unpack
# and pack.
_RELU = {"pack_ring", "unpack"}
_DENSE = {"beaver_and", "ks_mask", "ks_step", "ks_combine"}
_CONE = {"cone_step"}
PATH_KERNELS = {"exact": _RELU | {"ring_matmul"} | _DENSE,
                "reduced": _RELU | {"ring_matmul"} | _DENSE,
                "exact-cone": _RELU | {"ring_matmul"} | _CONE,
                "reduced-cone": _RELU | {"ring_matmul"} | _CONE,
                "lm-exact": _RELU | {"ring_matmul", "ring_matmul_ss"} | _DENSE,
                "lm-reduced": _RELU | {"ring_matmul", "ring_matmul_ss"} | _DENSE,
                "lm-long-exact": _RELU | {"ring_matmul", "ring_matmul_ss"} | _DENSE,
                "lm-long-reduced": _RELU | {"ring_matmul", "ring_matmul_ss"} | _DENSE,
                "lm-relu": _RELU | _DENSE,
                "search": _RELU | {"ring_matmul"} | _DENSE,
                "ragged-merge": _RELU | {"pack"} | _DENSE,
                "ragged-merge-cone": _RELU | {"pack"} | _CONE}
# each wrapper's kernel, by its symbol in a profiler trace (a captured
# replay's launches are counted there: the wrappers' counters do not tick)
TRACE_KERNELS = {k: f"{k}_kernel" for k in ("beaver_and", "ks_mask", "ks_combine",
                                            "ks_step", "ks_level", "cone_step",
                                            "ring_matmul", "ring_matmul_ss",
                                            "unpack", "pack")}
TRACE_KERNELS["pack_ring"] = "pack_kernel"      # one template serves both
# the wrappers, as ``lm_shape_launches`` / ``resnet_shape_launches`` key them
SHAPE_KERNELS = ("beaver_and", "ks_mask", "ks_step", "ks_combine", "ks_level",
                 "cone_step", "pack", "pack_ring", "unpack", "ring_matmul",
                 "ring_matmul_ss")
# timed online calls per plan and loop, after one warm-up call (once 3, cut
# to make room for the deploy phase); a ResNet plan's pool holds one
# call's triples, rolled back before each call (until PR 30 the pool held
# every call's, and the cone plans took one timed call to save pool time)
ONLINE_CALLS = 2
# exact-plan reveal vs plaintext: 16 fractional bits, +-1 LSB truncation
# per linear layer, amplified through 20 layers
ATOL, RTOL = 5e-2, 1e-2

# The LM path: Qwen1.5-0.5B at full width, depth cut to 2 layers, 2
# requests of 8 tokens as sibling streams, and each plan's fused rounds and
# bytes (``plan.schedule(streams=2)``, also checked against it)
LM_ARCH, LM_LAYERS, LM_SEQ, LM_STREAMS = "qwen1.5-0.5b", 2, 8, 2
# The long LM path: one request of LM_LONG_SEQ tokens, the reduced plan at
# depth 2 and the exact one at depth 1 (a 512-token exact call's ReLU
# triples take about 37 GB a layer); each plan's rounds and bytes
# (``plan.schedule(streams=1)``) below with the short path's
LM_LONG_SEQ = 512
LM_LONG_LAYERS = {"lm-long-exact": 1, "lm-long-reduced": 2}
LM_SCHEDULE = {"lm-exact": (46, 740753408), "lm-reduced": (40, 210809856),
               "lm-long-exact": (23, 12909019136),
               "lm-long-reduced": (40, 7598505984)}
# ring_matmul_ss's shape (B, M, K, N) off the LM paths: K past the kernel's
# 4096 split; its LM shapes and launches are read from the plans
# (``lm_shape_launches``)
RING_MATMUL_SS_OTHER_SHAPES = ((1, 64, 16512, 64),)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _event_ms(run, trials: int) -> list:
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def _graph_ms(fn, reps: int, trials: int) -> float:
    """Median time of ``reps`` calls of ``fn`` captured in one CUDA graph
    (the graph removes the host's per-call launch overhead)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return statistics.median(_event_ms(graph.replay, trials))


def device_ms(fn, flush, trials: int = 7, reps: int = 10):
    """(cold, hot) device time per call.  Cold: each call follows an L2
    flush (a write of more than the 50 MB L2), and the flushes' own time is
    subtracted; the kernels' inputs then come from device memory, as the
    bound assumes.  Hot: back-to-back calls, inputs left in L2."""
    with_flush = _graph_ms(lambda: (flush(), fn()), reps, trials)
    flush_only = _graph_ms(flush, reps, trials)
    return (with_flush - flush_only) / reps, _graph_ms(fn, reps, trials) / reps


def eager_ms(fn, trials: int = 7, reps: int = 20) -> float:
    """Per-call time of ``reps`` back-to-back eager calls (median over
    trials): the host's wrapper and launch cost where it exceeds the
    kernel's device time."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
    return statistics.median(_event_ms(run, trials)) / reps


def _card_generator(gen) -> torch.Generator:
    """A generator on the card seeded from the host generator ``gen``: the
    kernels' inputs are drawn there (the long LM path's hundreds of
    millions of words took seconds each on the host)."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
    return torch.Generator(device="cuda").manual_seed(seed)


def words(gen, *shape) -> torch.Tensor:
    """Random int32 words of ``shape`` on the card."""
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=_card_generator(gen),
                         dtype=torch.int32, device="cuda")


def ring_values(gen, *shape) -> torch.Tensor:
    """Random int64 ring values of ``shape`` on the card."""
    return torch.randint(-2 ** 63, 2 ** 63 - 1, shape, generator=_card_generator(gen),
                         dtype=torch.int64, device="cuda")


def max_abs_err(got, want) -> float:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        diff = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        if not torch.equal(g, w):
            raise AssertionError("kernel output differs from its plain version")
    return err


# timed_record's trials x reps for a function whose one warm eager call
# takes more than LONG_CALL_MS (the long LM path's shapes), where 7 x 10
# would take seconds; a plain version slower than SLOW_PLAIN_MS is timed by
# that one warm call alone
LONG_CALL_MS, LONG_TRIALS, LONG_REPS = 1.0, 3, 2
SLOW_PLAIN_MS = 50.0


def _once_ms(fn):
    """(result, ms) of one eager ``fn()``, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _device_ms_for(fn, flush, once_ms: float):
    """``device_ms(fn, flush)``, with fewer trials and reps for a long call."""
    if once_ms > LONG_CALL_MS:
        return device_ms(fn, flush, LONG_TRIALS, LONG_REPS)
    return device_ms(fn, flush)


def timed_record(into, flush, name, source, replaces, fn, plain, bytes_moved,
                 ops_s=0.0, shape="", path="exact"):
    """Check a kernel equal to its plain version, time both, append the
    record to ``into`` and return it."""
    err = max_abs_err(fn(), plain())
    once = _once_ms(fn)[1]
    ms, hot_ms = _device_ms_for(fn, flush, once)
    plain_once = _once_ms(plain)[1]
    plain_ms = (plain_once if plain_once > SLOW_PLAIN_MS
                else _device_ms_for(plain, flush, plain_once)[0])
    call_ms = eager_ms(fn, *((LONG_TRIALS, LONG_REPS) if once > LONG_CALL_MS else ()))
    bytes_s = bytes_moved / HBM_BYTES_PER_S
    bound_s = max(bytes_s, ops_s)
    into.append({"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": 0, "max_abs_err": err,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
                 "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                 "library_ms": None, "shape": shape, "hot_ms": hot_ms,
                 "eager_call_ms": call_ms, "path": path})
    print(f"kernel {name} [{shape}]: {ms:.4f} ms on the device from DRAM "
          f"({hot_ms:.4f} ms from L2, {call_ms:.4f} ms per eager call), "
          f"plain {plain_ms:.4f} ms, "
          f"bound {bound_s * 1e3:.4f} ms, max_abs_err {err}", flush=True)
    return into[-1]


def sass_census() -> dict:
    """Tensor-core and IMAD instructions in the compiled ring_matmul and
    ring_matmul_ss kernels, read from their SASS (``cuobjdump -sass``; a
    static count, prologue and epilogue included), and their registers and
    spills from ptxas's ``-v`` report (the large forms' shared memory is
    dynamic: ``kSmem`` in the sources).  Every kernel function of the
    sources: ring_matmul's one, ring_matmul_ss's large form and its small
    form's two instances (plain and transposed).  Fails if one is missing,
    has no tensor-core instruction (IMMA or IGMMA) or spills."""
    out = {}
    for source, kernel, count in (("ring_matmul.cu", "ring_matmul_kernel", 1),
                                  ("ring_matmul_ss.cu", "ring_matmul_ss_kernel", 3)):
        found = _sass_census(source, kernel)
        if len(found) != count:
            raise AssertionError(f"{source}: {len(found)} kernels named {kernel}*, "
                                 f"expected {count}: {sorted(found)}")
        out.update(found)
    return out


def _sass_census(source: str, kernel: str) -> dict:
    import re
    from repro_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    lib = build.build()[source]
    sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    out = {}
    for body in sass.split("Function :")[1:]:
        name = body.splitlines()[0].strip()
        if kernel not in name:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)",
                         body)
        count = {}
        for op in ops:
            if op.startswith(("IMMA", "IGMMA", "IMAD")):
                count[op] = count.get(op, 0) + 1
        imma = sum(n for op, n in count.items() if not op.startswith("IMAD"))
        out[name] = {"instructions": len(ops), "tensor_core": imma,
                     "imad": sum(n for op, n in count.items() if op.startswith("IMAD")),
                     "by_op": count}
        if imma == 0:
            raise AssertionError(f"{name}: no tensor-core instruction in its SASS")
    if not out:
        raise AssertionError(f"no {kernel} in the SASS")
    ptxas = build.build_log(source)
    for name, rec in out.items():
        i = ptxas.find(f"Function properties for {name}")
        report = ptxas[i:].splitlines()[1:3] if i >= 0 else []
        rec["ptxas"] = " ".join(line.strip() for line in report)
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill", rec["ptxas"])]
        if not report or any(spills):
            raise AssertionError(f"{name}: ptxas reports spills or nothing: "
                                 f"{rec['ptxas']!r}")
        print(f"{kernel} SASS {name}: {rec['instructions']} instructions, "
              f"tensor-core {rec['tensor_core']}, IMAD {rec['imad']} "
              f"{rec['by_op']}; ptxas: {rec['ptxas']}", flush=True)
    return out


# ring_matmul's (M, K, N) on the main path and its launches per call: each
# of the 4 requests' streams runs ResNet-18's 21 convs and fc on its own,
# M = 2 parties x OH x OW, K = Cin x kh x kw, N = Cout
RING_MATMUL_SHAPES = (
    (2048, 27, 64, 4), (2048, 576, 64, 16), (512, 576, 128, 4),
    (512, 1152, 128, 12), (512, 64, 128, 4), (128, 1152, 256, 4),
    (128, 2304, 256, 12), (128, 128, 256, 4), (32, 2304, 512, 4),
    (32, 4608, 512, 12), (32, 256, 512, 4), (2, 512, 10, 4))


def ring_matmul_bound_s(m: int, k: int, n: int):
    """(bytes s, operations s): each input read once and the output written
    once over the memory rate; the 26 plane products over the int8 rate."""
    return ((8 * m * k + 4 * k * n + 8 * m * n) / HBM_BYTES_PER_S,
            PLANE_PRODUCTS * 2 * m * k * n / INT8_OPS_PER_S)


def int_mm_ms(m: int, k: int, n: int, gen, planes: int = ISSUED_PLANE_PRODUCTS,
              batch: int = 1):
    """Yardstick of the tensor-core part: one int8 (M, K) @ (K, N) product
    through ``torch._int_mm`` (cuBLASLt), hot, times the ``planes`` plane
    products the kernel issues and the ``batch`` cells, where it takes the
    shape; None where it does not.  The port never calls it."""
    if m <= 16 or k % 8 or n % 8:
        return None
    a = torch.randint(-128, 128, (m, k), generator=_card_generator(gen),
                      dtype=torch.int8, device="cuda")
    b = torch.randint(-128, 128, (n, k), generator=_card_generator(gen),
                      dtype=torch.int8, device="cuda").t()
    try:
        return planes * batch * _graph_ms(lambda: torch._int_mm(a, b), 10, 7) / 10
    except RuntimeError as err:
        print(f"torch._int_mm refuses M={m} K={k} N={n}: {err}", flush=True)
        return None


def ring_matmul_phase(record, gen, lm_shapes=()) -> list:
    """ring_matmul at the 12 main-path shapes, the 4 requests' stem convs
    stacked (M x 4) and the LM paths' ``lm_shapes`` {(M, K, N): path},
    full-range x and w (w's extremes -2^31 and 2^31 - 1, x's bytes 0x00,
    0x80 and 0xFF among them); returns the records (the LM ones keyed
    ``lm_shape``)."""
    from repro_torch.kernels import ops, ref

    out = []
    for m, k, n, per_call in (RING_MATMUL_SHAPES + ((STREAMS * 2048, 576, 64, 0),)
                              + tuple(s + (0,) for s in lm_shapes)):
        x = ring_values(gen, m, k)
        x[0, :3] = torch.tensor([0, -1, -0x7F7F7F7F7F7F7F80])[:k]
        wt = words(gen, k, n)
        wt.view(-1)[:4] = torch.tensor([-2 ** 31, 2 ** 31 - 1, 0, -1],
                                       dtype=torch.int32)
        bytes_s, ops_s = ring_matmul_bound_s(m, k, n)
        row = record("ring_matmul", "src/repro_torch/csrc/ring_matmul.cu",
                     "src/repro/kernels/ring_matmul.py:88",
                     lambda: ops.ring_matmul(x, wt), lambda: ref.ring_matmul(x, wt),
                     bytes_s * HBM_BYTES_PER_S, ops_s=ops_s,
                     shape=f"M={m} K={k} N={n}")
        row["per_call"] = per_call
        if (m, k, n) in lm_shapes and not per_call:
            row["path"], row["lm_shape"] = lm_shapes[(m, k, n)], (m, k, n)
        row["int_mm_x30_ms"] = int_mm_ms(m, k, n, gen)
        if row["int_mm_x30_ms"] is not None:
            print(f"  yardstick: 30 x torch._int_mm at M={m} K={k} N={n}: "
                  f"{row['int_mm_x30_ms']:.4f} ms hot", flush=True)
        out.append(row)
    main = {(m, k, n): r for (m, k, n, c), r in zip(RING_MATMUL_SHAPES, out)}
    sums = call_sums(main, {(m, k, n): c for m, k, n, c in RING_MATMUL_SHAPES})
    print(f"ring_matmul per main-path call ({sums['launches']} launches): "
          f"{sums['ms']:.4f} ms from DRAM, {sums['hot_ms']:.4f} ms from L2, "
          f"{sums['eager_call_ms']:.4f} ms eager; card bound "
          f"{sums['bound_ms']:.4f} ms ({100 * sums['bound_ms'] / sums['ms']:.1f}%)",
          flush=True)
    for r in out:
        if "lm_shape" not in r:
            r["per_call_sums"] = sums
    return out


def ring_matmul_ss_bound_s(b: int, m: int, k: int, n: int):
    """(bytes s, operations s): x, y read once and the output written once
    over the memory rate; the 36 byte-plane products over the int8 rate."""
    return (8 * b * (m * k + k * n + m * n) / HBM_BYTES_PER_S,
            SS_PLANE_PRODUCTS * 2 * b * m * k * n / INT8_OPS_PER_S)


def ring_matmul_ss_phase(record, gen, lm_shapes) -> list:
    """ring_matmul_ss at the LM paths' ``lm_shapes`` {(B, M, K, N): path}
    and at ``RING_MATMUL_SS_OTHER_SHAPES`` against its plain version
    (``torch.equal``), full-range values (bytes 0x00, 0x80, 0xFF among
    them), each in the form its M picks (``ops.ss_form``, in the record as
    ``form``; one launch of that form per call, counted); returns the
    records (the LM ones keyed ``lm_shape``)."""
    from repro_torch.kernels import ops, ref

    out = []
    for b, m, k, n in tuple(lm_shapes) + RING_MATMUL_SS_OTHER_SHAPES:
        x, y = ring_values(gen, b, m, k), ring_values(gen, b, k, n)
        x.view(-1)[:3] = torch.tensor([0, -1, -0x7F7F7F7F7F7F7F80])
        y.view(-1)[:3] = torch.tensor([-1, 0, -2 ** 63])
        form = ops.ss_form(m)
        ops.reset_launches()
        ops.ring_matmul_ss(x, y)
        large = getattr(ops.ring_matmul_ss, "large", None)   # None: an older tree
        launched = ops.launch_counts()["ring_matmul_ss"]
        if launched != 1 or large not in (None, int(form == "large")):
            raise AssertionError(f"ring_matmul_ss at {(b, m, k, n)}: {launched} "
                                 f"launches, {large} large, its M picks {form}")
        bytes_s, ops_s = ring_matmul_ss_bound_s(b, m, k, n)
        row = record("ring_matmul_ss", "src/repro_torch/csrc/ring_matmul_ss.cu",
                     "src/repro/core/ring_linalg.py:72 (matmul_ring, a jnp einsum; "
                     "not a Pallas function)",
                     lambda: ops.ring_matmul_ss(x, y), lambda: ref.ring_matmul_ss(x, y),
                     bytes_s * HBM_BYTES_PER_S, ops_s=ops_s,
                     shape=f"B={b} M={m} K={k} N={n} {form}",
                     path=lm_shapes.get((b, m, k, n), "lm-exact"))
        row["form"] = form
        if (b, m, k, n) in lm_shapes:
            row["lm_shape"] = (b, m, k, n)
        row["int_mm_x36_ms"] = int_mm_ms(m, k, n, gen, SS_PLANE_PRODUCTS, b)
        if row["int_mm_x36_ms"] is not None:
            print(f"  yardstick: 36 x {b} x torch._int_mm at M={m} K={k} N={n}: "
                  f"{row['int_mm_x36_ms']:.4f} ms hot", flush=True)
        out.append(row)
    return out


def sign_plane_launches(plan: str) -> dict:
    """unpack's launches per main-path call at each sign plane's n."""
    out = {}
    for (n, relus), w in zip(RELU_GROUPS, PLAN_WIDTHS[plan]):
        if w:
            out[STREAMS * n] = out.get(STREAMS * n, 0) + relus
    return out


def pack_ring_launches(plan: str) -> dict:
    """pack_ring's launches per main-path call at each (k, m, E): one per
    ReLU, E the 4 requests' elements."""
    out = {}
    for (n, relus), w in zip(RELU_GROUPS, PLAN_WIDTHS[plan]):
        if w:
            shape = RING_BITS[w] + (STREAMS * n,)
            out[shape] = out.get(shape, 0) + relus
    return out


# pack_ring's seven main-path shapes (k, m, E)
PACK_RING_SHAPES = tuple(sorted({s for plan in PLAN_WIDTHS
                                 for s in pack_ring_launches(plan)}, reverse=True))
SUM_KEYS = ("ms", "hot_ms", "eager_call_ms", "bound_ms")


def call_sums(by_shape: dict, launches: dict) -> dict:
    """Launches x each of ``SUM_KEYS`` summed over a call's shapes, and the
    launches: ``by_shape`` maps each shape to its record."""
    out = {key: sum(c * by_shape[s][key] for s, c in launches.items())
           for key in SUM_KEYS}
    out["launches"] = sum(launches.values())
    return out


def adder_launches(plan: str) -> dict:
    """The adders' launches per main-path call, per ReLU of width w > 1:
    dense, with L = ceil(log2 w) levels, beaver_and (the initial AND),
    ks_mask and ks_combine once and ks_step L - 1 times; cone, one
    cone_step per round (the initial AND's and each non-empty cone
    level's) and no beaver_and or ks_level."""
    from repro_torch.core import gmw
    from repro_torch.core.schedule import n_levels

    out = dict.fromkeys(("beaver_and", "ks_mask", "ks_step", "ks_combine",
                         "ks_level", "cone_step"), 0)
    for (_, relus), w in zip(RELU_GROUPS, PLAN_WIDTHS[plan]):
        if w < 2:
            continue
        if plan.endswith("cone"):
            out["cone_step"] += relus * (1 + len(gmw._cone_levels(w)))
            continue
        out["beaver_and"] += relus
        out["ks_mask"] += relus
        out["ks_combine"] += relus
        out["ks_step"] += relus * (n_levels(w) - 1)
    return out


def cone_step_rows(w: int, r: int) -> int:
    """Rows of W words per party that the cone adder's round-r cone_step
    (r = 0: after the initial AND's exchange, r = i: after cone level
    i's) must read or write once: the sent and the received (d, e) and the
    round's triple (7 per AND row); g's updated rows (read and written
    after a level, written after the initial AND) and p's (written); the
    rows the next payload reads that this round did not touch, a' and b'
    read and (d', e') written (2n' rows each), or, after the last round,
    p[w-1] and the sign plane."""
    from repro_torch.core import gmw

    levels = gmw._cone_levels(w)
    if r == 0:
        and_rows, g_read, upd, p_written = w - 1, set(), set(range(w - 1)), set()
    else:
        _, first, step, n = levels[r - 1]
        and_rows, upd = 2 * n, set(range(first, first + step * n, step))
        g_read, p_written = upd, upd
    moved = 7 * and_rows + len(g_read) + len(upd) + len(p_written)
    if r < len(levels):
        lvl, first, step, n = levels[r]
        nxt = set(range(first, first + step * n, step))
        src = {i - (1 << lvl) for i in nxt}
        return moved + len((nxt | src) - p_written) + len(src - upd) + 8 * n
    return moved + (w - 1 not in p_written) + (w - 2 not in upd) + 1


def cone_step_bytes(w: int, r: int, n_words: int, parties: int = 2) -> int:
    """``cone_step_rows`` words per (party, word), and the (P,) selector."""
    return 4 * parties * (n_words * cone_step_rows(w, r) + 1)


def sign_plane_sums(sign_rows) -> dict:
    """Per plan, unpack's launches x ms per main-path call over the sign
    planes, from their rows (shape ``R=2 w=1 W=.. n=..``)."""
    by_n = {int(r["shape"].rsplit("n=", 1)[1]): r for r in sign_rows}
    out = {}
    for plan in PLAN_WIDTHS:
        out[plan] = call_sums(by_n, sign_plane_launches(plan))
        if plan.endswith("cone"):
            continue
        print(f"unpack per {plan} call ({out[plan]['launches']} sign planes): "
              f"{out[plan]['ms']:.4f} ms from DRAM, {out[plan]['hot_ms']:.4f} "
              f"ms from L2, {out[plan]['eager_call_ms']:.4f} ms eager; card "
              f"bound {out[plan]['bound_ms']:.4f} ms", flush=True)
    return out


def pack_ring_sums(rows) -> dict:
    """Per plan, the masked pack_ring's launches x ms per main-path call
    over its seven shapes, from their records (key ``pack_ring_shape``)."""
    by_shape = {r["pack_ring_shape"]: r for r in rows}
    out = {}
    for plan in PLAN_WIDTHS:
        out[plan] = call_sums(by_shape, pack_ring_launches(plan))
        if plan.endswith("cone"):
            continue
        print(f"pack_ring (masked) per {plan} call ({out[plan]['launches']} "
              f"ReLUs): {out[plan]['ms']:.4f} ms from DRAM, "
              f"{out[plan]['hot_ms']:.4f} ms from L2, "
              f"{out[plan]['eager_call_ms']:.4f} ms eager; card bound "
              f"{out[plan]['bound_ms']:.4f} ms", flush=True)
    return out


def cone_step_inputs(words, w: int, r: int, n_words: int, parties: int = 2):
    """Random inputs of the cone adder's round-r cone_step at width w (r =
    0: after the initial AND's exchange; r = i: after cone level i's), from
    ``words(*shape)``: ((sent, d_other, e_other, a, b, c), level, nxt),
    the peer's halves as views of a received round buffer and ``nxt`` the
    next level's ((first, step, shift), a_next, b_next), or () after the
    last round."""
    from repro_torch.core import gmw

    levels = gmw._cone_levels(w)
    rows = w - 1 if r == 0 else 2 * levels[r - 1][3]
    level = None if r == 0 else levels[r - 1][1:3]
    nxt = ()
    if r < len(levels):
        lvl, first, step, n = levels[r]
        nxt = ((first, step, 1 << lvl), words(parties, 2 * n, n_words),
               words(parties, 2 * n, n_words))
    opened = words(parties, 2, rows, n_words)
    args = (words(parties, 2, rows, n_words), opened[:, 0], opened[:, 1],
            *(words(parties, rows, n_words) for _ in range(3)))
    return args, level, nxt


def adder_records(record, gen, w: int, n_words: int, shifts, into, path,
                  shape_key: str = None) -> None:
    """The dense adder's kernels at width w over W = ``n_words`` words (P =
    2), each against its plain version: beaver_and plain and in its
    opening form (the sent payload and the peer's halves in the received
    round buffer, as the adder's initial AND runs it), ks_mask at shift 1,
    ks_combine, and ks_step (level l's combine fused with level l + 1's
    mask; g in place) at each of ``shifts``.  With ``shape_key`` each record
    the dense adder launches is keyed so (``lm_shape``, ``search_shape``), as
    ``lm_shape_launches`` / ``resnet_shape_launches`` count it."""
    from repro_torch.kernels import ops, ref

    P = 2

    def add(*args, key=None, **kwargs):
        row = record(*args, into=into, path=path, **kwargs)
        if shape_key and key is not None:
            row[shape_key] = key

    sel = torch.tensor([-1, 0], dtype=torch.int32, device="cuda")
    d, e, a, b, c = (words(gen, P, w, n_words) for _ in range(5))
    add("beaver_and", "src/repro_torch/csrc/gmw_round.cu",
        "src/repro/kernels/gmw_round.py:45",
        lambda: ops.beaver_and(d, e, a, b, c, sel),
        lambda: ref.beaver_and(d, e, a, b, c, sel),
        (6 * d.numel() + P) * 4, shape=f"P={P} w={w} W={n_words}")
    sent_ba, recv_ba = words(gen, P, 2, w, n_words), words(gen, P, 2, w, n_words)
    halves = (sent_ba[:, 0], sent_ba[:, 1], a, b, c, sel, recv_ba[:, 0],
              recv_ba[:, 1])
    add("beaver_and", "src/repro_torch/csrc/gmw_round.cu",
        "src/repro/kernels/gmw_round.py:45",
        lambda: ops.beaver_and(*halves), lambda: ref.beaver_and_open(*halves),
        (8 * d.numel() + P) * 4, shape=f"P={P} w={w} W={n_words} opening",
        key=(w, n_words))
    g, p = words(gen, P, w, n_words), words(gen, P, w, n_words)
    a2, b2 = words(gen, P, 2 * w, n_words), words(gen, P, 2 * w, n_words)
    add("ks_mask", "src/repro_torch/csrc/gmw_round.cu",
        "src/repro/kernels/gmw_round.py:73",
        lambda: ops.ks_mask(g, p, a2, b2, 1),
        lambda: torch.stack(ref.ks_mask(g, p, a2, b2, 1), dim=1),
        40 * P * w * n_words, shape=f"P={P} w={w} W={n_words} shift=1",
        key=(w, n_words))
    dd, ee, c2 = (words(gen, P, 2 * w, n_words) for _ in range(3))
    opened = words(gen, P, 2, 2 * w, n_words)       # the received round buffer
    add("ks_combine", "src/repro_torch/csrc/gmw_round.cu",
        "src/repro/kernels/gmw_round.py:105",
        lambda: ops.ks_combine(dd, opened[:, 0], ee, opened[:, 1], a2, b2, c2,
                               sel, g),
        lambda: ref.ks_combine(dd, opened[:, 0], ee, opened[:, 1], a2, b2, c2,
                               sel, g),
        68 * P * w * n_words + 4 * P, shape=f"P={P} w={w} W={n_words}",
        key=(w, n_words))
    # 96 bytes per (party, plane of w, word), g in place
    sent, a3, b3 = words(gen, P, 2, 2 * w, n_words), a2.flip(0), b2.flip(0)
    for shift in shifts:
        g3, g4 = g.clone(), g.clone()
        add("ks_step", "src/repro_torch/csrc/gmw_round.cu",
            "src/repro/kernels/gmw_round.py:105",
            lambda: ops.ks_step(sent, opened[:, 0], opened[:, 1], a2, b2, c2, sel,
                                g3, a3, b3, shift),
            lambda: ref.ks_step(sent, opened[:, 0], opened[:, 1], a2, b2, c2, sel,
                                g4, a3, b3, shift),
            96 * P * w * n_words + 4 * P,
            shape=f"P={P} w={w} W={n_words} shift={shift}", key=(w, n_words, shift))


def kernel_phase(lm_setups):
    """Each kernel against its plain version at main-path shapes: ResNet's,
    then the LM paths', read from the plans of ``lm_setups`` (``lm_setup``'s
    tuples: the short path's, the long path's)."""
    from repro_torch.core.schedule import n_levels
    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(0)
    n_el = 65536 * STREAMS                 # stem ReLU, 4 requests auto-batched
    n_words = (n_el + 31) // 32
    P = 2
    rows, extra = [], []
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MB

    def record(*args, into=rows, **kwargs):
        return timed_record(into, scratch.zero_, *args, **kwargs)

    for w, into in ((64, rows), (8, extra)):
        adder_records(record, gen, w, n_words, (2,), into, "exact")
    sel = torch.tensor([-1, 0], dtype=torch.int32, device="cuda")
    # the cone adder's combine (off the ResNet plans since cone_step took
    # it in) at the stem's first level, in place on the adder's (P, w-1, W)
    # g and p planes at rows 2, 4, ..., w-2 (n = 31 of the exact plan's
    # w = 64; n = 3 of the reduced plan's w = 8).  Its 20 bytes
    # per (party, row, word) are g, z_g, z_p read and g, p written; the plain
    # version does the same in-place update.
    for w, into in ((64, rows), (8, extra)):
        n = w // 2 - 1
        g, p = words(gen, P, w - 1, n_words), words(gen, P, w - 1, n_words)
        z = words(gen, P, 2 * n, n_words)          # the level's AND output
        g2, p2 = g.clone(), p.clone()
        record("ks_level", "src/repro_torch/csrc/gmw_round.cu",
               "src/repro/kernels/gmw_round.py:134",
               lambda: ops.ks_level(g, p, z, 2, 2),
               lambda: ref.ks_level(g2, p2, z, 2, 2),
               20 * P * n * n_words, shape=f"P={P} planes={w - 1} n={n} W={n_words}",
               into=into, path="exact-cone")
    # the cone adder's fused round step at the stem (w = 64: after the
    # initial AND, writing level 0's payload; after level 0, writing level
    # 1's) and after w = 8's last level (n = 1, the sign plane); g and p
    # are updated in place, so the kernel and the plain version each get
    # their own copies, and both are compared with the output
    for w, r, into in ((64, 1, rows), (64, 0, extra), (8, 3, extra)):
        args, level, nxt = cone_step_inputs(lambda *sh: words(gen, *sh), w, r,
                                            n_words, P)
        rows_r = args[0].shape[2]
        g, p = words(gen, P, w - 1, n_words), words(gen, P, w, n_words)
        g2, p2 = g.clone(), p.clone()
        record("cone_step", "src/repro_torch/csrc/gmw_round.cu",
               "src/repro/kernels/gmw_round.py:45",
               lambda: (ops.cone_step(*args, sel, g, p, level, *nxt), g, p),
               lambda: (ref.cone_step(*args, sel, g2, p2, level, *nxt), g2, p2),
               cone_step_bytes(w, r, n_words, P),
               shape=f"P={P} w={w} round={r} rows={rows_r} W={n_words}",
               into=into, path="exact-cone" if w == 64 else "reduced-cone")
    # the A2B input: bits m..k-1 of the merged shares, XORed with the A2B
    # masks in the same launch, at the seven main-path shapes (the stem's
    # (64, 0) is a row of the kernels line), then the unmasked form at the
    # stem's two shapes
    masked = []
    for k, m, e in PACK_RING_SHAPES:
        x = ring_values(gen, P, e)
        r = words(gen, P, k - m, (e + 31) // 32)
        row = record("pack_ring", "src/repro_torch/csrc/bitpack.cu",
                     "src/repro/kernels/bitpack.py:44",
                     lambda: ops.pack_ring(x, k, m, mask=r),
                     lambda: ref.pack_ring(x, k, m, r),
                     8 * P * e + 8 * r.numel(),
                     shape=f"P={P} E={e} k={k} m={m} masked",
                     into=rows if (k, m, e) == (64, 0, n_el) else extra,
                     path="exact" if k - m == 64 else "reduced")
        row["pack_ring_shape"] = (k, m, e)
        masked.append(row)
    sums = pack_ring_sums(masked)
    for row in masked:
        row["per_call_sums"] = sums
    x = ring_values(gen, P, n_el)
    for (k, m), into in (((64, 0), rows), ((21, 13), extra)):
        record("pack_ring", "src/repro_torch/csrc/bitpack.cu",
               "src/repro/kernels/bitpack.py:44",
               lambda: ops.pack_ring(x, k, m), lambda: ref.pack_ring(x, k, m),
               8 * P * n_el + 4 * P * (k - m) * n_words,
               shape=f"P={P} E={n_el} k={k} m={m}", into=into)
    # unpack: the four sign planes (w = 1 over the parties' rows; the
    # stem's is the row of the kernels line); the bit-route merge's unpack of one
    # stream's bin_init (P x 64 planes) at the ragged path's n and at the
    # stem's; w = 8 and 32 at the stem's n
    sign = []
    for rows_, w, n, path in ([(P, 1, n, "exact") for n in SIGN_PLANES]
                              + [(P * 64, 1, RAGGED_N, "ragged-merge"),
                                 (P * 64, 1, n_el // STREAMS, "ragged-merge"),
                                 (P, 8, n_el, "exact"), (P, 32, n_el, "exact")]):
        packed = words(gen, rows_, w, (n + 31) // 32)
        row = record("unpack", "src/repro_torch/csrc/bitpack.cu",
                     "src/repro/kernels/bitpack.py:60",
                     lambda: ops.unpack(packed, n), lambda: ref.unpack(packed, n),
                     4 * packed.numel() + 4 * rows_ * n,
                     shape=f"R={rows_} w={w} W={packed.shape[-1]} n={n}",
                     into=rows if n == n_el and w == 1 else extra, path=path)
        if rows_ == P and w == 1:
            sign.append(row)
    sums = sign_plane_sums(sign)
    for row in sign:
        row["per_call_sums"] = sums
    # pack: the ragged-merge path's repack of the 4 streams' bin_init bits,
    # one plane per row (P x 64 rows, the row of the kernels line), and the
    # parent's main-path shapes at the stem (w = 64 exact, w = 8 reduced)
    for rows_, e, into in ((P * 64, STREAMS * RAGGED_N, rows), (P * 64, n_el, extra),
                           (P * 8, n_el, extra)):
        bits = torch.randint(0, 2, (rows_, e), generator=gen,
                             dtype=torch.int32).cuda()
        record("pack", "src/repro_torch/csrc/bitpack.cu",
               "src/repro/kernels/bitpack.py:44",
               lambda: ops.pack(bits, 1), lambda: ref.pack(bits, 1),
               4 * rows_ * e + 4 * rows_ * ((e + 31) // 32),
               shape=f"R={rows_} E={e} w=1", into=into, path="ragged-merge")
    # the LM paths' shapes, read from their plans (``lm_shape_launches``):
    # the dense adder at each plan's widths over each of its word counts
    # (W of the streams' merged E), ks_step at every level's shift;
    # pack_ring (masked) at each (k, m, E); unpack at each sign plane;
    # ring_matmul at each projection and the lm_head; ring_matmul_ss at
    # each product (its short-path QK^T Beaver combine is the row of the
    # kernels line); each per LM call beside its bound.  A shape's record
    # takes the first plan that launches it as its path.
    lm_counts = {name: lm_shape_launches(plan, setup)
                 for setup in lm_setups for name, plan in setup[2].items()}

    def lm_paths(kernel):
        out = {}
        for name, c in lm_counts.items():
            for shape in c[kernel]:
                out.setdefault(shape, name)
        return out

    # every conv and fc: the stage-1 conv (16 launches per call) is the
    # row of the kernels line, the other shapes go with the extra records
    for row in ring_matmul_phase(lambda *a, **kw: record(*a, into=extra, **kw),
                                 gen, lm_paths("ring_matmul")):
        if row["shape"] == "M=2048 K=576 N=64":
            extra.remove(row)
            rows.append(row)
    lm_rows = []
    adder = {}
    for name, c in lm_counts.items():
        widths = {w for w, _ in c["ks_mask"]}
        for n_w in sorted({n_w for _, n_w in c["ks_mask"]}):
            for w in widths:
                adder.setdefault((w, n_w), name)
    for (w, n_w), name in sorted(adder.items(), key=lambda a: (-a[0][0], a[0][1])):
        adder_records(record, gen, w, n_w,
                      tuple(1 << lvl for lvl in range(1, n_levels(w))), lm_rows,
                      name, shape_key="lm_shape")
    for (k, m, e), name in sorted(lm_paths("pack_ring").items(), reverse=True):
        x = ring_values(gen, P, e)
        r = words(gen, P, k - m, (e + 31) // 32)
        record("pack_ring", "src/repro_torch/csrc/bitpack.cu",
               "src/repro/kernels/bitpack.py:44",
               lambda: ops.pack_ring(x, k, m, mask=r), lambda: ref.pack_ring(x, k, m, r),
               8 * P * e + 8 * r.numel(), shape=f"P={P} E={e} k={k} m={m} masked",
               into=lm_rows, path=name)
        lm_rows[-1]["lm_shape"] = (k, m, e)
        del x, r
    for n, name in sorted(lm_paths("unpack").items(), reverse=True):
        packed = words(gen, P, 1, (n + 31) // 32)
        record("unpack", "src/repro_torch/csrc/bitpack.cu",
               "src/repro/kernels/bitpack.py:60",
               lambda: ops.unpack(packed, n), lambda: ref.unpack(packed, n),
               4 * packed.numel() + 4 * P * n,
               shape=f"R={P} w=1 W={packed.shape[-1]} n={n}", into=lm_rows, path=name)
        lm_rows[-1]["lm_shape"] = n
    for row in ring_matmul_ss_phase(lambda *a, **kw: record(*a, into=lm_rows, **kw),
                                    gen, dict(sorted(lm_paths("ring_matmul_ss").items()))):
        if row.get("lm_shape") == (32, 8, 128, 8):
            lm_rows.remove(row)
            rows.append(row)
    extra += lm_rows
    lm_sums = {}
    for name, counts in lm_counts.items():
        for kernel, launches in counts.items():
            if not launches:
                continue
            by_shape = {r["lm_shape"]: r for r in rows + extra
                        if r["name"] == kernel and "lm_shape" in r}
            sums = call_sums(by_shape, launches)
            lm_sums.setdefault(kernel, {})[name] = sums
            print(f"{kernel} per {name} call ({sums['launches']} launches at "
                  f"{len(launches)} shapes): {sums['ms']:.4f} ms from DRAM, "
                  f"{sums['hot_ms']:.4f} ms from L2, {sums['eager_call_ms']:.4f} ms "
                  f"eager; card bound {sums['bound_ms']:.4f} ms", flush=True)
    for row in rows + extra:
        if "lm_shape" in row:
            row["lm_per_call_sums"] = lm_sums[row["name"]]
    return rows, extra


def resnet_setup():
    """Full-width ResNet-18 (seeded weights), its four plans, the 4
    requests' inputs and the plaintext logits."""
    import dataclasses

    from repro_torch.configs import RESNET18
    from repro_torch.core.hummingbird import HBConfig, HBLayer
    from repro_torch.models import resnet

    cfg = RESNET18
    params = resnet.init(cfg, seed=0, device="cuda")
    plan_exact = resnet.trace(params, cfg, batch=1)
    plan_reduced = plan_exact.with_hb(HBConfig(
        tuple([HBLayer(k=21, m=13)] * (plan_exact.n_groups - 1)
              + [HBLayer(k=13, m=13)]), plan_exact.group_elements))
    gen = torch.Generator().manual_seed(1)
    xs = [(torch.rand((1, 3, cfg.in_hw, cfg.in_hw), generator=gen) * 2 - 1).cuda()
          for _ in range(STREAMS)]
    with torch.no_grad():
        plaintext = resnet.ResNet(params, cfg)
        want = torch.cat([plaintext(x) for x in xs])
    plans = {"exact": plan_exact, "reduced": plan_reduced,
             "exact-cone": dataclasses.replace(plan_exact, cone=True),
             "reduced-cone": dataclasses.replace(plan_reduced, cone=True)}
    return cfg, params, plans, xs, want


def _call(model, enc, mode, key, cc):
    """One online call on the round loop ``mode`` (``HB_ROUND_LOOP``) with
    the request key ``key``: host clock around work ended by
    ``torch.cuda.synchronize()``, launch counters zeroed just before and
    read just after, and the rounds and bytes it added to ``cc``."""
    from repro_torch.kernels import ops

    os.environ["HB_ROUND_LOOP"] = mode
    r0, b0 = cc.n_rounds, cc.bytes_tx
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = model(enc, key=key)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    counts["pack_ring_masked"] = ops.pack_ring.masked
    return {"outs": outs, "wall": wall, "counts": counts,
            "rounds": cc.n_rounds - r0, "bytes": cc.bytes_tx - b0}


def _check_call(name, run, sched, want, errs):
    """Rounds and bytes equal to the schedule; finite logits of the right
    shape; the exact plans' reveals (ResNet's and the LM's) within the
    tolerance."""
    if (run["rounds"], run["bytes"]) != (sched.n_rounds, sched.bytes_tx):
        raise AssertionError(f"{name}: measured {run['rounds']} rounds / "
                             f"{run['bytes']} B != schedule {sched.n_rounds} / "
                             f"{sched.bytes_tx}")
    got = torch.cat([o.reveal() for o in run["outs"]])
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: bad output {tuple(got.shape)}")
    errs.append(float((got - want).abs().max()))
    if name.startswith(("exact", "lm-exact", "lm-long-exact")) and \
            errs[-1] > ATOL + RTOL * float(want.abs().max()):
        raise AssertionError(f"{name} plan: max error {errs[-1]} vs plaintext")


def _same_shares(name, a, b, what):
    if not all(torch.equal(x.data, y.data) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: {what}")


class NoDeviceTrace(AssertionError):
    """A profiler trace that holds no device activity."""


PROFILE_TRIES = 3
PROFILE_PAD_S = 0.02


def _profiled(fn, census=None, again: bool = False, optional: bool = False):
    """(busy s, span s, device ops, busy share, top) of one traced ``fn()``.
    A trace can come back with no device activity although the host
    launched work (short traces, such as the replay's input refill, have
    on the card); each trace therefore keeps ``PROFILE_PAD_S`` of idle time
    on both sides of ``fn()``.  With ``again`` (for an ``fn`` that may run
    twice) an empty trace is taken again, up to ``PROFILE_TRIES`` traces;
    with ``optional`` as well, the last empty trace gives None (the caller
    writes "not measured") where it would raise."""
    for attempt in range(1, PROFILE_TRIES + 1):
        try:
            return _profiled_once(fn, census)
        except NoDeviceTrace as e:
            if not again or (attempt == PROFILE_TRIES and not optional):
                raise
            print(f"{e} (trace {attempt} of {PROFILE_TRIES})", flush=True)
    return None


def _profiled_once(fn, census=None):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(PROFILE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    busy_us, span_us, n_ops, top, lag_us = trace_busy(prof, census)
    return {"span_s": span_us / 1e6, "device_busy_s": busy_us / 1e6,
            "device_ops": n_ops, "device_busy_share": busy_us / span_us,
            "top_device_ops_us": top, "min_launch_lag_us": lag_us}


def host_profile(fn, top=8):
    """One ``fn()`` under cProfile (which slows the Python-heavy parts
    most): its host seconds and the ``top`` functions by own time,
    [file:line(function), own s, calls]."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof)
    rows = sorted(([f"{os.path.basename(f)}:{line}({func})", own, calls]
                   for (f, line, func), (_, calls, own, _, _) in stats.stats.items()),
                  key=lambda r: -r[1])
    return {"total_s": stats.total_tt, "top": rows[:top]}


def replay_census(name, census, launches):
    """The kernels a traced replay ran, by symbol (``TRACE_KERNELS``),
    against the launches its capture counted; raises on a difference."""
    want, got = {}, {}
    for wrapper, symbol in TRACE_KERNELS.items():
        want[symbol] = want.get(symbol, 0) + launches[wrapper]
    # a symbol, demangled or not, never preceded by a letter (unpack_kernel
    # holds pack_kernel)
    pattern = re.compile(r"(?<![A-Za-z_])(" + "|".join(set(TRACE_KERNELS.values()))
                         + ")")
    for op, count in census.items():
        m = pattern.search(op)
        if m:
            got[m.group(1)] = got.get(m.group(1), 0) + count
    got = {s: got.get(s, 0) for s in want}
    if got != want:
        raise AssertionError(f"{name}: the traced replay ran {got}, its capture "
                             f"counted {want}")
    return got


def online_calls(name, plan, setup, calls=ONLINE_CALLS, expect=None,
                 profile=False, want_launches=None, keep_reveal=False):
    """One plan's offline phase (one call's triple pool, rolled back before
    every call: each call has its own request key, the pool's triples are
    the same), then each online call twice, on the same request key and
    the same triples: on the generator loop (``HB_ROUND_LOOP=python``), then
    on the captured replay (``scan``) where the tree has it.  The first pair warms
    up (the replay's first call runs the generator loop and captures the
    graph); ``calls`` timed pairs follow (host clock around work ended by
    ``torch.cuda.synchronize()``).  Every call: rounds and bytes equal to
    the schedule, the exact plans' reveals within the tolerance.  Eager
    calls (``expect``): exactly the path's kernels, the adders' launches as
    their levels say, one unpack and one masked pack_ring per ReLU.
    Replays: shares equal to the eager call's, no launch counted on the
    host, the graph's captured launches equal to the eager call's, a
    result held across the next replay unchanged.  Then one replay (and
    with ``profile`` one eager call) under torch.profiler, the replay's
    kernels counted by name against its capture; the replay's input
    refill and the eager key split timed alone.  ``want_launches`` (a
    kernel -> launches per call dict, read from a plan) replaces the
    plan-name tables as the eager calls' count to hold; ``keep_reveal``
    returns the last eager call's revealed logits under ``reveal``."""
    from repro_torch import api
    from repro_torch.core import comm as comm_lib, prng
    from repro_torch.models import resnet

    cfg, params, _, xs, want = setup

    def afn(p, x, relu_fn=None):
        return resnet.apply(p, x, cfg, relu_fn=relu_fn)

    cc = comm_lib.CoalescingComm(comm_lib.SimComm())
    requests = 1 + calls
    session = api.Session(key=0, comm=cc, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    session.offline(prng.PRNGKey(7, "cuda"), plan, requests=1, streams=STREAMS)
    torch.cuda.synchronize()
    offline_s = time.perf_counter() - t0
    provider = session.provider
    pool_bytes = provider.device_bytes()
    token = provider.checkpoint()
    model = api.compile(afn, params, cfg, plan, session)
    replay = hasattr(model, "replay_stats")
    enc = [model.encrypt(prng.PRNGKey(100 + i, "cuda"), x) for i, x in enumerate(xs)]
    keys = [prng.PRNGKey(1000 + i, "cuda") for i in range(requests)]
    sched = plan.schedule(streams=STREAMS)
    want_adder = None
    if want_launches is not None:
        want_adder = dict(want_launches, pack_ring_masked=want_launches["pack_ring"])
    elif expect is not None:
        want_adder = adder_launches(name)
        want_adder["unpack"] = sum(sign_plane_launches(name).values())
        want_adder["pack_ring"] = want_adder["pack_ring_masked"] = want_adder["unpack"]
    eager, replays, errs, held = [], [], [], None
    for i in range(requests):
        provider.rollback(token)            # every call on the one call's pool
        e = _call(model, enc, "python", keys[i], cc)
        _check_call(name, e, sched, want, errs)
        counts = e["counts"]
        launched = {k for k, v in counts.items() if v and k != "pack_ring_masked"}
        if expect is not None and launched != expect:
            raise AssertionError(f"{name}: launched {sorted(launched)}, its path "
                                 f"runs {sorted(expect)}")
        if want_adder is not None:
            got_adder = {k: counts[k] for k in want_adder}
            if got_adder != want_adder:
                raise AssertionError(f"{name}: launched {got_adder}, its "
                                     f"levels and ReLUs say {want_adder}")
        if i:
            eager.append(e)
        if not replay:
            continue
        provider.rollback(token)
        r = _call(model, enc, "scan", keys[i], cc)
        _check_call(name, r, sched, want, errs)
        _same_shares(name, r["outs"], e["outs"], "replay shares differ from the "
                     "eager call's")
        stats = model.replay_stats(enc)
        if stats is None or stats["launches"] != counts:
            raise AssertionError(f"{name}: the captured replay holds "
                                 f"{stats and stats['launches']}, the eager call "
                                 f"launched {counts}")
        if i == 0:
            # the signature's first call: the generator loop, then the capture
            if r["counts"] != {k: 2 * v for k, v in counts.items()}:
                raise AssertionError(f"{name}: first scan call launched "
                                     f"{r['counts']}, twice the eager call is "
                                     f"{counts}")
            continue
        if any(r["counts"].values()):
            raise AssertionError(f"{name}: a replay launched {r['counts']} from "
                                 "the host")
        if held is not None:
            _same_shares(name, held[0], held[1], "a held replay result changed "
                         "under the next replay")
        held = (r["outs"], [type(o)(o.data.clone(), o.frac_bits) for o in r["outs"]])
        replays.append(r)
    os.environ["HB_ROUND_LOOP"] = "python"
    counts = eager[-1]["counts"]
    masked = counts.pop("pack_ring_masked")
    out = {"offline_s": offline_s, "offline_s_per_call": offline_s,
           "pool_requests": 1, "pool_bytes": pool_bytes,
           "rounds": sched.n_rounds, "bytes": sched.bytes_tx,
           "max_abs_err_vs_plaintext": max(errs), "launches": counts,
           "pack_ring_masked": masked}
    if keep_reveal:
        out["reveal"] = torch.cat([o.reveal() for o in eager[-1]["outs"]])
    for loop, runs in (("eager", eager), ("replay", replays)):
        if runs:
            walls = [r["wall"] for r in runs]
            out[loop] = {"online_s": walls, "online_median_s": statistics.median(walls),
                         "online_min_s": min(walls), "online_max_s": max(walls)}
    ea = out["eager"]
    print(f"main path {name}: offline {offline_s:.3f} s for one call's pool "
          f"({pool_bytes} B on the device, rolled back before each of the "
          f"{requests} calls); online per call ({STREAMS} requests) on the "
          f"generator loop: "
          f"median {ea['online_median_s']:.4f} s, min {ea['online_min_s']:.4f}, "
          f"max {ea['online_max_s']:.4f} over {calls} warm calls; "
          f"{sched.n_rounds} rounds, {sched.bytes_tx} B, launches {counts}, max "
          f"|reveal - plaintext| {max(errs):.3g} (max |logit| "
          f"{float(want.abs().max()):.3g})", flush=True)
    last = keys[-1]
    if replay:
        stats = model.replay_stats(enc)
        entry = model._replay_entry(enc)
        srcs = [t.clone() for t in entry.statics]
        refill_ms = statistics.median(_event_ms(lambda: entry.load(srcs), 7))
        refill = _profiled(lambda: entry.load(srcs), again=True, optional=True)
        refill_bytes = sum(2 * t.numel() * t.element_size() for t in srcs)
        del srcs
        split_s = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prng.split(last, 256 * STREAMS)
            torch.cuda.synchronize()
            split_s.append(time.perf_counter() - t0)
        census = {}
        provider.rollback(token)
        os.environ["HB_ROUND_LOOP"] = "scan"
        traced = _profiled(lambda: model(enc, key=last), census)
        traced["kernels_by_name"] = replay_census(name, census, stats["launches"])
        provider.rollback(token)
        host = host_profile(lambda: model(enc, key=last))
        out["replay"].update({
            "trace_s": stats["trace_s"], "compile_s": stats["compile_s"],
            "captured_launches": stats["launches"], "refill_ms": refill_ms,
            "refill_device_ops": refill and refill["device_ops"],
            "refill_bytes": refill_bytes,
            "refill_bound_ms": refill_bytes / HBM_BYTES_PER_S * 1e3,
            "key_split_s": statistics.median(split_s), "profiled": traced,
            "host_profile": host})
        rp = out["replay"]
        refill_ops = (f"{rp['refill_device_ops']} launches" if refill else
                      "launches not measured (every trace came back empty)")
        print(f"main path {name} on the captured replay: median "
              f"{rp['online_median_s']:.4f} s, min {rp['online_min_s']:.4f}, max "
              f"{rp['online_max_s']:.4f} over {calls} warm calls (shares equal "
              f"the eager calls', counters the schedule, captured launches the "
              f"eager call's); capture {rp['trace_s']:.3f} s, instantiation, "
              f"upload and first replay {rp['compile_s']:.3f} s; input refill "
              f"{refill_ms:.4f} ms on the device in {refill_ops} for "
              f"{refill_bytes} B (bound {rp['refill_bound_ms']:.4f} "
              f"ms); eager key split {1e3 * rp['key_split_s']:.4f} ms; one replay "
              f"under the profiler: {traced['device_ops']} device ops busy "
              f"{traced['device_busy_s']:.4f} s of a {traced['span_s']:.4f} s trace "
              f"= {100 * traced['device_busy_share']:.1f}%, kernels by name "
              f"{traced['kernels_by_name']}; one replay under cProfile: "
              f"{host['total_s']:.4f} s of host time, most in {host['top']}",
              flush=True)
    if profile:
        provider.rollback(token)
        os.environ["HB_ROUND_LOOP"] = "python"
        out["profiled"] = pr = _profiled(lambda: model(enc, key=last))
        print(f"main path {name}, one online call on the generator loop under "
              f"the profiler: {pr['device_ops']} device ops busy "
              f"{pr['device_busy_s']:.4f} s of a {pr['span_s']:.4f} s trace = "
              f"{100 * pr['device_busy_share']:.1f}%; most device time: "
              f"{pr['top_device_ops_us']}", flush=True)
    os.environ.pop("HB_ROUND_LOOP", None)
    return out


def main_path_phase():
    """Full-width ResNet-18, 4 sibling streams, exact and reduced plans,
    each with the dense and the cone-pruned adder: offline pool, warm-up,
    timed online calls on both round loops."""
    setup = resnet_setup()
    runs, launches = {}, {}
    for name, plan in setup[2].items():
        runs[name] = online_calls(name, plan, setup, expect=PATH_KERNELS[name],
                                  profile=name == "exact")
        for k, v in runs[name]["launches"].items():
            launches.setdefault(k, {})[name] = v
    return runs, launches


def lm_setup(layers: int = LM_LAYERS, seq: int = LM_SEQ, streams: int = LM_STREAMS,
             names=("lm-exact", "lm-reduced")):
    """Qwen1.5-0.5B at full width, ``layers`` layers, seeded random float32
    weights at the reference's init scales; the plans ``names`` (a name
    ending in "exact": every ReLU group (64, 0); in "reduced": (22, 0) on the
    attention-score groups, (22, 6) on the PWL groups), ``streams`` requests'
    hidden states of ``seq`` tokens and the plaintext twin's logits (float32
    on the card, TF32 off): ``(cfg, params, plans, hs, want)``."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core.hummingbird import HBConfig, HBLayer
    from repro_torch.models import lm

    cfg = dataclasses.replace(configs.get(LM_ARCH), n_layers=layers,
                              dtype="float32")
    params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    plan = lm.trace(params, cfg, 1, seq)
    reduced = plan.with_hb(HBConfig(
        tuple(HBLayer(k=22, m=0) if g % 2 == 0 else HBLayer(k=22, m=6)
              for g in range(plan.n_groups)), plan.group_elements))
    plans = {n: reduced if n.endswith("reduced") else plan for n in names}
    gen = torch.Generator(device="cuda").manual_seed(1)
    hs = [torch.randn((1, seq, cfg.d_model), generator=gen, device="cuda") * 0.5
          for _ in range(streams)]
    with torch.no_grad():
        want = torch.cat([lm.mpc_reference(params, h, cfg) for h in hs])
    return cfg, params, plans, hs, want


def lm_long_setups():
    """The long LM path's setups: one request of ``LM_LONG_SEQ`` tokens, each
    plan at its own depth (``LM_LONG_LAYERS``)."""
    return [lm_setup(layers, LM_LONG_SEQ, 1, (name,))
            for name, layers in LM_LONG_LAYERS.items()]


def lm_shape_launches(plan, setup, merged: bool = True) -> dict:
    """Each kernel's launches per LM call by shape, read from the plan and
    ``setup`` (its weights, its requests' count S and length T): per ReLU
    call (the S streams merged into one of E = S x its elements, W =
    ceil(E / 32) words; with ``merged`` False, as the serving engine runs
    them, each stream on its own at E = its elements), one masked
    pack_ring at (k, m, E), one unpack of the sign plane at E and the dense
    adder's beaver_and, ks_mask and ks_combine at (w, W) and ks_step at (w,
    W, 2^l) for each level l > 0; ring_matmul at (2T, K, N) per stream for
    every layer's q, k, v, o projections, up, gate and down weights (K, N)
    and the lm_head; per matmul open and stream, ring_matmul_ss at (H, M,
    K, N) (the triple's C = A @ B) and at (2H, M, 2K, N) (the Beaver combine
    [E | A_p] @ [B_p + [p = 0] F ; F], the parties' cells stacked), (M, K,
    N) the product (QK^T or A@V) whose H (MK + KN) elements the open
    carries."""
    from repro_torch.core.schedule import n_levels

    cfg, params, _, hs, _ = setup
    streams, seq = len(hs), hs[0].shape[1]
    out = {k: {} for k in SHAPE_KERNELS}

    def add(kernel, shape, n=1):
        out[kernel][shape] = out[kernel].get(shape, 0) + n

    per = 1 if merged else streams
    for c in plan.calls:
        layer = plan.hb.layers[c.group]
        e = streams * c.n_elements // per
        n_words = (e + 31) // 32
        add("pack_ring", (layer.k, layer.m, e), per)
        add("unpack", e, per)
        if layer.width < 2:
            continue
        for k in ("beaver_and", "ks_mask", "ks_combine"):
            add(k, (layer.width, n_words), per)
        for lvl in range(1, n_levels(layer.width)):
            add("ks_step", (layer.width, n_words, 1 << lvl), per)
    layers = params["layers"]
    weights = [layers["attn"][p]["w"] for p in ("wq", "wk", "wv", "wo")]
    weights += [layers["mlp"][p] for p in ("w_up", "w_gate", "w_down")
                if p in layers["mlp"]]
    for w in weights:                              # (layers, K, N)
        add("ring_matmul", (2 * seq, w.shape[1], w.shape[2]), streams * w.shape[0])
    add("ring_matmul", (2 * seq,) + tuple(params["lm_head"]["w"].shape), streams)
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    for o in plan.opens:
        if o.label != "matmul":
            continue
        mkn = [p for p in ((seq, dh, seq), (seq, seq, dh))
               if h * (p[0] * p[1] + p[1] * p[2]) == o.n_elements]
        if len(mkn) != 1:
            raise AssertionError(f"matmul open of {o.n_elements} elements is "
                                 f"neither QK^T nor A@V")
        m, k, n = mkn[0]
        add("ring_matmul_ss", (h, m, k, n), streams)
        add("ring_matmul_ss", (2 * h, m, 2 * k, n), streams)
    return out


def lm_online(name, plan, setup, calls=ONLINE_CALLS):
    """One LM plan, one warm-up call and ``calls`` timed calls on the
    generator loop, each after its own offline ReLU triple pool (made
    before the timer, the previous call's freed first: the long path's
    pool holds one call) and each checked (rounds and bytes, the path's
    launches per kernel and ring_matmul_ss's large form, the exact plans'
    error).  Then the last call again, its pool rolled back, with
    ``HB_ROUND_LOOP=scan`` (same shares, nothing captured) and under the
    profiler."""
    from repro_torch import api
    from repro_torch.core import comm as comm_lib, prng
    from repro_torch.kernels import ops

    cfg, params, _, hs, want = setup
    streams, seq = len(hs), hs[0].shape[1]
    sched = plan.schedule(streams=streams)
    if (sched.n_rounds, sched.bytes_tx) != LM_SCHEDULE[name]:
        raise AssertionError(f"{name}: schedule {sched.n_rounds} rounds / "
                             f"{sched.bytes_tx} B, expected {LM_SCHEDULE[name]}")
    cc = comm_lib.CoalescingComm(comm_lib.SimComm())
    requests = 1 + calls
    session = api.Session(key=0, comm=cc, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    model = api.compile(None, params, cfg, plan, session)
    enc = [model.encrypt(prng.PRNGKey(100 + i, "cuda"), h) for i, h in enumerate(hs)]
    keys = [prng.PRNGKey(1000 + i, "cuda") for i in range(requests)]
    shapes = lm_shape_launches(plan, setup)
    expect = {k: sum(v.values()) for k, v in shapes.items()}
    large = sum(c for (_, m, _, _), c in shapes["ring_matmul_ss"].items()
                if ops.ss_form(m) == "large")
    limit = ATOL + RTOL * float(want.abs().max())
    runs, errs, offline_s = [], [], []
    for i in range(requests):
        session.provider = None             # the previous call's pool freed first
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.offline(prng.PRNGKey(7 + i, "cuda"), plan, requests=1,
                        streams=streams)
        torch.cuda.synchronize()
        offline_s.append(time.perf_counter() - t0)
        token = session.provider.checkpoint()
        run = _call(model, enc, "python", keys[i], cc)
        run["ss_large"] = ops.ring_matmul_ss.large
        _check_call(name, run, sched, want, errs)
        counts = dict(run["counts"])
        masked = counts.pop("pack_ring_masked")
        launched = {k for k, v in counts.items() if v}
        if launched != PATH_KERNELS[name] or masked != counts["pack_ring"] or \
                any(counts[k] != v for k, v in expect.items()) or \
                run["ss_large"] != large:
            raise AssertionError(f"{name}: launched {counts} ({masked} pack_ring "
                                 f"masked, {run['ss_large']} ring_matmul_ss large), "
                                 f"its path runs {expect} ({large} large)")
        if runs:
            runs[-1].pop("outs")            # only the last call's shares are kept
        if i:
            runs.append(run)
    walls = [r["wall"] for r in runs]
    last, eager = keys[-1], runs[-1]
    pool_bytes = session.provider.device_bytes()
    session.provider.rollback(token)
    scan = _call(model, enc, "scan", last, cc)
    _same_shares(name, scan["outs"], eager["outs"], "HB_ROUND_LOOP=scan gives other "
                 "shares than python")
    if model.replay_stats(enc) is not None or scan["counts"] != eager["counts"]:
        raise AssertionError(f"{name}: a plan with opens was captured or launched "
                             f"{scan['counts']} under scan")
    del scan, eager["outs"]
    session.provider.rollback(token)
    os.environ["HB_ROUND_LOOP"] = "python"
    prof = _profiled(lambda: model(enc, key=last))
    os.environ.pop("HB_ROUND_LOOP", None)
    peak = torch.cuda.max_memory_allocated()
    session.provider = None
    counts = dict(eager["counts"])
    counts.pop("pack_ring_masked")
    out = {"offline_s": offline_s, "offline_median_s": statistics.median(offline_s),
           "pool_requests": 1, "pool_bytes": pool_bytes, "rounds": sched.n_rounds,
           "bytes": sched.bytes_tx, "layers": cfg.n_layers, "seq": seq,
           "streams": streams,
           "max_abs_err_vs_plaintext": max(errs), "err_limit": limit,
           "max_abs_logit": float(want.abs().max()), "launches": counts,
           "ring_matmul_ss_large": eager["ss_large"],
           "online_s": walls, "online_median_s": statistics.median(walls),
           "online_min_s": min(walls), "online_max_s": max(walls),
           "resident_bytes": resident, "peak_bytes": peak,
           "scan_equals_python": True, "profiled": prof}
    print(f"LM path {name} ({LM_ARCH}, {cfg.n_layers} layers, {streams} requests of "
          f"{seq} tokens): one pool of {pool_bytes} B per call, made in "
          f"{', '.join(f'{t:.3f}' for t in offline_s)} s; online per call on the "
          f"generator loop: median {out['online_median_s']:.4f} s, min "
          f"{out['online_min_s']:.4f}, max {out['online_max_s']:.4f} over {calls} "
          f"warm calls; {sched.n_rounds} rounds, {sched.bytes_tx} B; launches "
          f"{counts}, ring_matmul_ss {eager['ss_large']} large; max |reveal - "
          f"plaintext| {max(errs):.4g} (limit {limit:.4g}, max |logit| "
          f"{out['max_abs_logit']:.4g}); peak {peak} B allocated ({resident} B "
          f"resident before); scan == python; one call under the profiler: "
          f"{prof['device_ops']} device ops busy {prof['device_busy_s']:.4f} s of a "
          f"{prof['span_s']:.4f} s trace = {100 * prof['device_busy_share']:.1f}%, "
          f"most device time {prof['top_device_ops_us']}", flush=True)
    return out


def lm_path_phase(setup):
    """The LM path under its two plans; returns the runs and each kernel's
    launches per path."""
    runs, launches = {}, {}
    for name, plan in setup[2].items():
        runs[name] = lm_online(name, plan, setup)
        for k, v in runs[name]["launches"].items():
            launches.setdefault(k, {})[name] = v
    return runs, launches


def lm_long_phase(setups):
    """The long LM path (``lm_long_setups``): one request of ``LM_LONG_SEQ``
    tokens, the exact plan at depth 1 and the reduced one at depth 2, each
    call after its own offline pool (``lm_online``); returns the runs and
    each kernel's launches per path."""
    runs, launches = {}, {}
    for setup in setups:
        for name, plan in setup[2].items():
            runs[name] = lm_online(name, plan, setup)
            for k, v in runs[name]["launches"].items():
                launches.setdefault(k, {})[name] = v
    return runs, launches


def relu_card_vs_cpu(name, n, k, m, streams, cone, seed):
    """``gmw.relu_many`` on ``streams`` sibling streams of n elements at
    (k, m), seeded inputs, keys and triples, on the CPU (the plain
    versions) and on the card: launch counters zeroed just before the
    card's run and read just after; it must launch exactly its
    ``PATH_KERNELS``, pack_ring with the A2B mask every time, and its
    shares must equal the CPU run's bit for bit.  Returns the card's
    (launches, rounds, bytes)."""
    from repro_torch.core import beaver, comm as comm_lib, gmw, prng
    from repro_torch.kernels import ops

    outs = {}
    for dev in ("cpu", "cuda"):
        gen = torch.Generator().manual_seed(seed)
        xs = [torch.randint(-2 ** 63, 2 ** 63 - 1, (2, n), generator=gen,
                            dtype=torch.int64).to(dev) for _ in range(streams)]
        keys = [prng.PRNGKey(400 + i, dev) for i in range(streams)]
        tris = [beaver.gen_relu_triples(prng.PRNGKey(500 + i, dev), n, k - m,
                                        cone=cone) for i in range(streams)]
        cc = comm_lib.CoalescingComm(comm_lib.SimComm())
        if dev == "cuda":
            torch.cuda.synchronize()
            ops.reset_launches()
        outs[dev] = gmw.relu_many(keys, xs, tris, cc, [(k, m)] * streams, cone=cone)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts, masked = ops.launch_counts(), ops.pack_ring.masked
    launched = {kn for kn, v in counts.items() if v}
    if launched != PATH_KERNELS[name] or masked != counts["pack_ring"]:
        raise AssertionError(f"{name}: launched {sorted(launched)} ({masked} "
                             f"pack_ring masked), its path runs "
                             f"{sorted(PATH_KERNELS[name])}, pack_ring masked")
    for got, want in zip(outs["cuda"], outs["cpu"]):
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"{name}: shares differ from the CPU run")
    print(f"{name}: {streams} streams x {n} elements at ({k}, {m}), launches "
          f"{counts}, shares equal the CPU run's", flush=True)
    return counts, cc.n_rounds, cc.bytes_tx


def ragged_merge_phase():
    """``gmw.relu_many`` on 4 sibling streams of ``RAGGED_N`` elements, dense
    at (64, 0) and with the cone at (21, 13): not a multiple of 32, so the
    streams' triples merge at the bit level (unpack, cat, pack); each equal
    to the CPU run (``relu_card_vs_cpu``)."""
    runs, launches = {}, {}
    for name, (k, m), cone in (("ragged-merge", (64, 0), False),
                               ("ragged-merge-cone", (21, 13), True)):
        counts, rounds, bytes_tx = relu_card_vs_cpu(name, RAGGED_N, k, m, STREAMS,
                                                    cone, 3)
        for kn, v in counts.items():
            launches.setdefault(kn, {})[name] = v
        runs[name] = {"n_per_stream": RAGGED_N, "k": k, "m": m,
                      "rounds": rounds, "bytes": bytes_tx, "launches": counts}
    return runs, launches


def lm_relu_phase(setup):
    """The LM path's ReLU calls at full width, one per (k, m, n) of either
    plan (n a request's elements): ``gmw.relu_many`` on ``LM_STREAMS``
    sibling streams on the card, equal bit for bit to the CPU run
    (``relu_card_vs_cpu``; the reduced plan's logits are only reported, so
    this is where its (22, 0) and (22, 6) ReLUs are held to the plain
    versions at the path's sizes)."""
    plans = setup[2]
    sites = sorted({(plan.hb.layers[c.group].k, plan.hb.layers[c.group].m,
                     c.n_elements) for plan in plans.values() for c in plan.calls},
                   reverse=True)
    out = []
    for k, m, n in sites:
        counts, rounds, bytes_tx = relu_card_vs_cpu("lm-relu", n, k, m, LM_STREAMS,
                                                    False, 5)
        out.append({"n_per_stream": n, "k": k, "m": m, "rounds": rounds,
                    "bytes": bytes_tx, "launches": counts})
    return out


def merge_phase(flush):
    """The stem's 4 streams' triples merged by ``concat_relu_triples`` (the
    word route) and by the bit route of the ragged case
    (``beaver._cat_bin_bits``: unpack, cat, pack), exact dense (w = 64) and
    exact-cone.  Bytes: the word route reads and writes every member once,
    which is also the bound; the bit route adds 4 bytes per bit written by
    unpack, read and written by the cat and read by pack."""
    from repro_torch.core import beaver, prng

    n, w = RELU_GROUPS[0][0], 64
    out = {}
    for plan, cone in (("exact", False), ("exact-cone", True)):
        bundles = [beaver.gen_relu_triples(prng.PRNGKey(600 + i, "cuda"), n, w,
                                           cone=cone) for i in range(STREAMS)]
        routes = {
            "word": lambda: beaver.concat_relu_triples(bundles, [n] * STREAMS, w,
                                                       cone=cone),
            "bit": lambda: beaver._concat(bundles, [n] * STREAMS, w, cone,
                                          beaver._cat_bin_bits)}
        merged = {r: beaver.relu_tensors(fn()) for r, fn in routes.items()}
        if not all(torch.equal(a, b) for a, b in zip(merged["word"], merged["bit"])):
            raise AssertionError(f"merge {plan}: the word and bit routes differ")
        members = [t for b in bundles for t in beaver.relu_tensors(b)]
        word_bytes = sum(2 * t.numel() * t.element_size() for t in members)
        bits = sum(32 * t.numel() for t in members if t.dtype == torch.int32)
        traffic = {"word": word_bytes, "bit": word_bytes + 16 * bits}
        out[plan] = {"bound_ms": word_bytes / HBM_BYTES_PER_S * 1e3}
        for route, fn in routes.items():
            ms, hot_ms = device_ms(fn, flush, trials=5, reps=1)
            call_ms = eager_ms(fn, trials=3, reps=2)
            out[plan][route] = {"ms": ms, "hot_ms": hot_ms, "eager_call_ms": call_ms,
                                "bytes": traffic[route]}
            print(f"merge {plan} ({STREAMS} x {n} elements, w = {w}) by {route}s: "
                  f"{ms:.4f} ms on the device from DRAM ({hot_ms:.4f} ms from L2, "
                  f"{call_ms:.4f} ms per eager call), {traffic[route]} B moved; "
                  f"bound {out[plan]['bound_ms']:.4f} ms", flush=True)
    return out


def trace_busy(prof, census=None):
    """(busy us, span us, device ops, top, lag us) of one profiler trace:
    the union of the device's kernel, memcpy and memset intervals, the span
    from the trace's first event to its last, the 8 device-op names with
    the most summed time ([name, us, count], the name cut to 60
    characters), and the least time from a host-side launch to the start of
    its device op (below 0 where the trace's device clock runs ahead of the
    host's; None where no device op is correlated with a launch).
    ``census``, a dict, gets every device op's full name and count."""
    path = os.path.join(ROOT, "build", "profile_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    timed = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
             for e in events if e.get("ph") == "X"]
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                    for e in ops)
    by_name = {}
    for e in ops:
        rec = by_name.setdefault(str(e.get("name"))[:60], [0.0, 0])
        rec[0] += float(e.get("dur", 0))
        rec[1] += 1
        if census is not None:
            census[str(e.get("name"))] = census.get(str(e.get("name")), 0) + 1
    top = sorted(([n, us, c] for n, (us, c) in by_name.items()),
                 key=lambda r: -r[1])[:8]
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}
    if not device:
        raise NoDeviceTrace(f"the profiler traced no device activity "
                            f"({len(launches)} host-side CUDA runtime calls traced)")
    lags = [float(e["ts"]) - launches[e["args"]["correlation"]] for e in ops
            if e.get("args", {}).get("correlation") in launches]
    busy, (start, end) = 0.0, device[0]
    for a, b in device[1:]:
        if a > end:
            busy += end - start
            start, end = a, b
        else:
            end = max(end, b)
    busy += end - start
    span = max(b for _, b in timed) - min(a for a, _ in timed)
    return busy, span, len(device), top, min(lags, default=None)


def stem_breakdown_phase():
    """Where the time of one ReLU layer goes: the exact plan's stem layer
    (conv + ReLU) for 4 requests, timed by part on the host clock around
    synchronised work: the conv; the triples' offline generation (one
    ``EagerTTP`` pool for the 4 streams); the online protocol, its triples
    popped from that pool.  The dense and the cone adder in turns (dense,
    cone, cone, dense; the faster of each pair is kept), then the dense
    layer's online part (conv + protocol, triples pooled beforehand) once
    more under torch.profiler for the device's busy share of that one
    traced run (the profiler slows the host, so the share is likely below
    the unprofiled run's)."""
    from repro_torch.configs import RESNET18
    from repro_torch.core import beaver, comm as comm_lib, gmw, prng
    from repro_torch.core.mpc_tensor import MPCTensor
    from repro_torch.models import resnet

    params = resnet.init(RESNET18, seed=0, device="cuda")
    w, b = resnet.fold_bn(params["stem"], params["bn_stem"])
    gen = torch.Generator().manual_seed(2)
    xs = [MPCTensor.from_plain(prng.PRNGKey(200 + i, "cuda"),
                               (torch.rand((1, 3, 32, 32), generator=gen) * 2 - 1).cuda())
          for i in range(STREAMS)]
    keys = [prng.PRNGKey(300 + i, "cuda") for i in range(STREAMS)]
    n = RESNET18.widths[0] * 32 * 32

    def conv():
        return [x.conv2d_public(w, 1, 1).add_public(b[:, None, None]) for x in xs]

    def triples(cone=False):
        return beaver.EagerTTP(prng.PRNGKey(7, "cuda"), [(n, 64)], cone=cone,
                               streams=STREAMS)

    def protocol(hs, pool, cone=False):
        tris = [pool.relu_triples(n, 64, cone=cone) for _ in range(STREAMS)]
        return gmw.relu_many(keys, [h.data.reshape(2, n) for h in hs], tris,
                             comm_lib.CoalescingComm(), [(64, 0)] * STREAMS,
                             cone=cone)

    def timed(fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for cone in (False, True):                      # warm-up
        protocol(conv(), triples(cone), cone=cone)
    hs, t_conv = timed(conv)
    parts = {False: [], True: []}
    for cone in (False, True, True, False):
        pool, t_triples = timed(triples, cone)
        _, t_protocol = timed(protocol, hs, pool, cone=cone)
        parts[cone].append((t_triples, t_protocol))
    (t_triples, t_protocol), (c_triples, c_protocol) = (
        tuple(min(t[i] for t in parts[cone]) for i in range(2))
        for cone in (False, True))
    pool = triples()
    pr = _profiled(lambda: protocol(conv(), pool))
    out = {"conv_s": t_conv, "triples_offline_s": t_triples,
           "protocol_online_s": t_protocol, "cone_triples_offline_s": c_triples,
           "cone_protocol_online_s": c_protocol,
           "profiled_span_s": pr["span_s"], "device_busy_s": pr["device_busy_s"],
           "device_kernels": pr["device_ops"],
           "device_busy_share": pr["device_busy_share"]}
    print(f"stem layer, 4 requests: conv {t_conv:.4f} s, triples offline "
          f"(pool) {t_triples:.4f} s, protocol online {t_protocol:.4f} s (cone "
          f"adder: triples {c_triples:.4f} s, protocol {c_protocol:.4f} s); "
          f"online under the profiler: {pr['device_ops']} device ops busy "
          f"{pr['device_busy_s']:.4f} s of a {pr['span_s']:.4f} s trace = "
          f"{100 * pr['device_busy_share']:.1f}%", flush=True)
    return out


# The search path (the paper's §4.1, as examples/private_inference.py runs
# it): ResNet-18 finetuned on synthetic images, HummingBird-eco and -b on
# the validation images, the budget search's plan served
SEARCH_IMAGES, SEARCH_TRAIN, SEARCH_VAL = 512, (0, 384), (384, 448)
SEARCH_SERVE = 448                      # the STREAMS served images start here
SEARCH_EPOCHS, SEARCH_BATCH, SEARCH_LR = 4, 64, 3e-3
SEARCH_BUDGET, SEARCH_BITS = 8 / 64, (6, 8)


def relu_shape_launches(relus, out: dict = None) -> dict:
    """Each ReLU kernel's launches by shape for ``relus``, (E, HBLayer)
    pairs of one dense ReLU call each: for width w > 0 (W = E / 32 words)
    one masked pack_ring at (k, m, E) and one unpack of the sign plane at
    E; for w > 1 the dense adder's beaver_and, ks_mask and ks_combine at
    (w, W) and ks_step at (w, W, 2^l) for each level l > 0."""
    from repro_torch.core.schedule import n_levels

    out = out if out is not None else {k: {} for k in SHAPE_KERNELS}

    def add(kernel, shape, n=1):
        out[kernel][shape] = out[kernel].get(shape, 0) + n

    for e, layer in relus:
        if layer.width == 0:
            continue
        n_words = (e + 31) // 32
        add("pack_ring", (layer.k, layer.m, e))
        add("unpack", e)
        if layer.width < 2:
            continue
        for k in ("beaver_and", "ks_mask", "ks_combine"):
            add(k, (layer.width, n_words))
        for lvl in range(1, n_levels(layer.width)):
            add("ks_step", (layer.width, n_words, 1 << lvl))
    return out


def resnet_matmul_shapes(cfg, hw: int, rows: int) -> tuple:
    """ring_matmul's (M, K, N, launches) in one stream of a ResNet's MPC
    forward on ``rows`` images of hw x hw (parties x the request's images),
    read from a shape-only trace of the plaintext forward: each conv one
    launch at M = rows x OH x OW, K = Cin x kh x kw, N = Cout, the fc one
    at M = rows."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import resnet

    found = {}

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.ops.aten.convolution.default:
                cout, cin, kh, kw = args[1].shape
                key = (rows * out.shape[-2] * out.shape[-1], cin * kh * kw, cout)
            elif func is torch.ops.aten.mm.default:
                key = (rows, *args[1].shape)
            else:
                return out
            found[key] = found.get(key, 0) + 1
            return out

    params = resnet.init(cfg, seed=0, device="meta")
    x = torch.empty(1, 3, hw, hw, device="meta")
    with Shapes():
        resnet.apply(params, x, cfg)
    return tuple((m, k, n, c) for (m, k, n), c in found.items())


def resnet_shape_launches(plan, streams: int = STREAMS, batch: int = 1,
                          out: dict = None, matmuls=None) -> dict:
    """Each kernel's launches per ResNet call of a dense plan, by shape,
    read from the plan: ``relu_shape_launches`` of its ReLU calls (the
    ``streams`` requests merged into E = ``streams`` x its elements);
    ring_matmul once a stream per ``matmuls`` entry (M, K, N, launches per
    stream), by default ResNet-18's ``RING_MATMUL_SHAPES`` with M times the
    requests' ``batch``.  A serving batch runs its streams unmerged: sum
    ``streams=1`` over its requests into one ``out``."""
    if plan.cone:
        raise ValueError("resnet_shape_launches counts the dense adder only")
    out = relu_shape_launches(((streams * c.n_elements, plan.hb.layers[c.group])
                               for c in plan.calls), out)
    if matmuls is None:
        matmuls = tuple((m * batch, k, n, c // STREAMS)
                        for m, k, n, c in RING_MATMUL_SHAPES)
    for m, k, n, c in matmuls:
        out["ring_matmul"][(m, k, n)] = out["ring_matmul"].get((m, k, n), 0) + c * streams
    return out


def search_kernel_phase(by_shape: dict, path: str = "search") -> list:
    """Each ReLU kernel against its plain version at a plan's own shapes
    (``resnet_shape_launches``): the dense adder at every (w, W) and shift,
    masked pack_ring at every (k, m, E), unpack at every sign plane; each
    record keyed ``<path>_shape`` (the search's found plan, the serving
    batches)."""
    from repro_torch.core.schedule import n_levels
    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(4)
    key = f"{path}_shape"
    P = 2
    rows = []
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")

    def record(*args, into=rows, **kwargs):
        return timed_record(into, scratch.zero_, *args, **kwargs)

    for w, n_w in sorted(by_shape["ks_mask"], reverse=True):
        adder_records(record, gen, w, n_w,
                      tuple(1 << lvl for lvl in range(1, n_levels(w))), rows,
                      path, shape_key=key)
    for k, m, e in sorted(by_shape["pack_ring"], reverse=True):
        x = ring_values(gen, P, e)
        r = words(gen, P, k - m, (e + 31) // 32)
        record("pack_ring", "src/repro_torch/csrc/bitpack.cu",
               "src/repro/kernels/bitpack.py:44",
               lambda: ops.pack_ring(x, k, m, mask=r), lambda: ref.pack_ring(x, k, m, r),
               8 * P * e + 8 * r.numel(), shape=f"P={P} E={e} k={k} m={m} masked",
               path=path)[key] = (k, m, e)
    for n in sorted(by_shape["unpack"], reverse=True):
        packed = words(gen, P, 1, (n + 31) // 32)
        record("unpack", "src/repro_torch/csrc/bitpack.cu",
               "src/repro/kernels/bitpack.py:60",
               lambda: ops.unpack(packed, n), lambda: ref.unpack(packed, n),
               4 * packed.numel() + 4 * P * n,
               shape=f"R={P} w=1 W={packed.shape[-1]} n={n}",
               path=path)[key] = n
    return rows


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def search_phase():
    """The paper's search path on full-width ResNet-18 (``RESNET18``, seeded
    weights at the reference's init scales), as
    ``examples/private_inference.py`` runs it: ``SEARCH_IMAGES`` synthetic
    images (``ImagePipeline``) on the card; ``finetune`` with the exact
    config on the training images (4 epochs, batch 64, lr 3e-3); the
    serving plan traced at batch 1; ``search_eco`` on the validation
    images (its accuracy must equal the baseline) and ``search_budget`` at
    ``SEARCH_BUDGET`` over ``SEARCH_BITS`` (its config must meet the
    budget), both scored for ``STREAMS`` sibling streams; one candidate's
    evaluation timed and profiled (host against device); the simulator on
    the card against the CPU at the stem's full-width activations; then the
    budget search's plan served to ``STREAMS`` requests (``online_calls``:
    triples offline, both round loops, every call's rounds and bytes equal
    to ``plan.schedule(streams=4)`` and to the search's ``objective_value``,
    exactly the plan's launches per kernel), and every ReLU kernel held
    against its plain version at the plan's shapes.  Returns (record,
    kernel records, launches per kernel)."""
    import torch.nn.functional as F

    from repro_torch.api import LAN, WAN
    from repro_torch.configs import RESNET18
    from repro_torch.core import prng
    from repro_torch.data import ImagePipeline
    from repro_torch.models import resnet
    from repro_torch.search import finetune as ft, search_budget, search_eco, simulator

    cfg = RESNET18

    def afn(p, x, relu_fn=None):
        return resnet.apply(p, x, cfg, relu_fn=relu_fn)

    (xs, ys), data_s = _timed(lambda: ImagePipeline(n_classes=cfg.n_classes,
                                                    hw=cfg.in_hw).take(SEARCH_IMAGES,
                                                                       device="cuda"))
    params = resnet.init(cfg, seed=0, device="cuda")
    plan = resnet.trace(params, cfg, batch=1)
    (params, losses), finetune_s = _timed(lambda: ft.finetune(
        afn, params, xs[slice(*SEARCH_TRAIN)], ys[slice(*SEARCH_TRAIN)], plan.hb,
        prng.PRNGKey(1, "cuda"), epochs=SEARCH_EPOCHS, batch=SEARCH_BATCH,
        lr=SEARCH_LR))
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        raise AssertionError(f"search: finetune losses not finite: {losses}")
    xv, yv = xs[slice(*SEARCH_VAL)], ys[slice(*SEARCH_VAL)]
    base_acc = simulator.evaluate_accuracy(afn, params, xv, yv, plan.hb,
                                           prng.PRNGKey(2, "cuda"))
    print(f"search: {SEARCH_IMAGES} images in {data_s:.3f} s; finetune "
          f"({len(losses)} steps) {finetune_s:.3f} s, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; baseline accuracy {base_acc:.4f} on "
          f"{xv.shape[0]} validation images", flush=True)
    eco = search_eco(afn, params, xv, yv, plan, prng.PRNGKey(3, "cuda"),
                     streams=STREAMS)
    if not eco.accuracy == eco.baseline_accuracy == base_acc:
        raise AssertionError(f"search_eco: accuracy {eco.accuracy}, baseline "
                             f"{eco.baseline_accuracy} / {base_acc}")
    print(f"search_eco: {[(l.k, l.m) for l in eco.config.layers]}, "
          f"{eco.budget_fraction:.4f} of the bits, accuracy {eco.accuracy:.4f} "
          f"(= baseline), {eco.nodes_visited} nodes, {eco.search_time_s:.3f} s, "
          f"{eco.objective_value:.0f} B per call", flush=True)
    visited = []
    res = search_budget(afn, params, xv, yv, plan, prng.PRNGKey(4, "cuda"),
                        budget=SEARCH_BUDGET, bit_choices=SEARCH_BITS,
                        objective="bytes", streams=STREAMS, on_visit=visited.append)
    found = res.plan
    if not res.config.meets_budget(SEARCH_BUDGET) or found.hb != res.config:
        raise AssertionError(f"search_budget: {res.config} misses {SEARCH_BUDGET}")
    cands_per_s = len(visited) / res.search_time_s
    lan = found.estimate(network=LAN, streams=STREAMS)
    wan = found.estimate(network=WAN, streams=STREAMS)
    print(f"search_budget: {[(l.k, l.m) for l in res.config.layers]}, "
          f"{res.budget_fraction:.4f} of the bits, accuracy {res.accuracy:.4f} "
          f"(drop {res.baseline_accuracy - res.accuracy:.4f}), {res.nodes_visited} "
          f"nodes visited, {res.nodes_pruned} pruned, {len(visited)} candidates "
          f"evaluated in {res.search_time_s:.3f} s ({cands_per_s:.2f} per s); "
          f"{res.objective_value:.0f} B per call; estimate LAN {lan:.6f} s, "
          f"WAN {wan:.6f} s", flush=True)
    # one candidate's evaluation: the host's wall against the device's work
    with simulator.deterministic():
        walls = [_timed(lambda: simulator.evaluate_accuracy(
            afn, params, xv, yv, res.config, prng.PRNGKey(4, "cuda")))[1]
            for _ in range(3)]
        cand = _profiled(lambda: simulator.evaluate_accuracy(
            afn, params, xv, yv, res.config, prng.PRNGKey(4, "cuda")), again=True)
    cand["wall_s"] = statistics.median(walls)
    print(f"one candidate (the found config, {xv.shape[0]} images): "
          f"{cand['wall_s']:.4f} s on the host clock; under the profiler "
          f"{cand['device_ops']} device ops busy {cand['device_busy_s']:.4f} s of a "
          f"{cand['span_s']:.4f} s trace = {100 * cand['device_busy_share']:.1f}%; "
          f"most device time {cand['top_device_ops_us']}", flush=True)
    # the simulator on the card against the CPU at the stem's activations
    stem = []

    def keep_stem(v, g):
        if g == 0:
            stem.append(v)
        return F.relu(v)

    with torch.no_grad():
        afn(params, xv, relu_fn=keep_stem)
    sim = []
    t0 = time.perf_counter()
    for i, (k, m) in enumerate(((21, 13), (48, 8), (eco.config.layers[0].k, 0))):
        key = 10 + i
        card = simulator.simulated_hb_relu(stem[0], k, m, prng.PRNGKey(key, "cuda"))
        cpu = simulator.simulated_hb_relu(stem[0].cpu(), k, m, prng.PRNGKey(key, "cpu"))
        if not torch.equal(card.cpu(), cpu):
            raise AssertionError(f"simulated_hb_relu ({k}, {m}) on the card differs "
                                 "from the CPU")
        sim.append({"k": k, "m": m, "shape": list(stem[0].shape)})
    sim_s = time.perf_counter() - t0
    print(f"simulated_hb_relu at the stem's {tuple(stem[0].shape)}: card == CPU at "
          f"{[(r['k'], r['m']) for r in sim]} ({sim_s:.3f} s, both devices)", flush=True)
    # serve the found plan
    lo = SEARCH_SERVE
    serve_x = [xs[lo + i:lo + i + 1] for i in range(STREAMS)]
    with torch.no_grad():
        want = torch.cat([afn(params, x) for x in serve_x])
    by_shape = resnet_shape_launches(found)
    per_call = {k: sum(v.values()) for k, v in by_shape.items()}
    run = online_calls("search", found, (cfg, params, None, serve_x, want),
                       expect=PATH_KERNELS["search"], want_launches=per_call,
                       keep_reveal=True)
    if float(run["bytes"]) != res.objective_value or \
            run["launches"]["ring_matmul"] != per_call["ring_matmul"]:
        raise AssertionError(f"search: served {run['bytes']} B / launches "
                             f"{run['launches']}, the search predicted "
                             f"{res.objective_value} B and {per_call}")
    reveal = run.pop("reveal").argmax(-1)
    with torch.no_grad(), simulator.deterministic():
        simulated = afn(params, torch.cat(serve_x),
                        relu_fn=simulator.make_group_relu(found.hb,
                                                          prng.PRNGKey(5, "cuda")))
    agree_sim = float((reveal == simulated.argmax(-1)).float().mean())
    agree_plain = float((reveal == want.argmax(-1)).float().mean())
    print(f"search plan served: {STREAMS} requests, {run['rounds']} rounds, "
          f"{run['bytes']} B per call (= the search's objective_value); top-1 "
          f"agreement of the revealed logits with the simulated model "
          f"{agree_sim:.2f}, with the plaintext model {agree_plain:.2f}", flush=True)
    rows, records_s = _timed(lambda: search_kernel_phase(by_shape))
    sums = {}
    for kernel, launches in by_shape.items():
        if not launches or kernel == "ring_matmul":
            continue
        shapes = {r["search_shape"]: r for r in rows
                  if r["name"] == kernel and "search_shape" in r}
        sums[kernel] = call_sums(shapes, launches)
        print(f"{kernel} per search-plan call ({sums[kernel]['launches']} launches at "
              f"{len(launches)} shapes): {sums[kernel]['ms']:.4f} ms from DRAM, "
              f"{sums[kernel]['hot_ms']:.4f} ms from L2, "
              f"{sums[kernel]['eager_call_ms']:.4f} ms eager; card bound "
              f"{sums[kernel]['bound_ms']:.4f} ms", flush=True)
    for row in rows:
        row["search_per_call_sums"] = sums
    out = {"images": SEARCH_IMAGES, "data_s": data_s, "finetune_s": finetune_s,
           "finetune_steps": len(losses), "losses": losses,
           "loss_first": losses[0], "loss_last": losses[-1],
           "baseline_accuracy": base_acc,
           "eco": eco.to_json(), "budget": res.to_json(),
           "budget_candidates": len(visited), "candidates_per_s": cands_per_s,
           "estimate_lan_s": lan, "estimate_wan_s": wan, "candidate": cand,
           "simulator_card_equals_cpu": sim, "simulator_check_s": sim_s,
           "kernel_records_s": records_s, "served": run,
           "agreement_with_simulated": agree_sim,
           "agreement_with_plaintext": agree_plain,
           "launches_by_shape": {k: {str(s): n for s, n in v.items()}
                                 for k, v in by_shape.items()},
           "per_call_sums": sums}
    return out, rows, dict(run["launches"])


# The serving phases.  ``serve``: an InferenceEngine over full-width
# ResNet-18's reduced plan, BatchPolicy(max_batch=4), three tenants (carol's
# element budget holds one request, so her second overruns it), requests
# with explicit ids in submission order (id, tenant, batch, deadline_s);
# the policy forms [0-3], [4-7] (5 fails its budget) and [8, 9] (9 is shed):
# three stream signatures (4 singles, 3 singles, 1 double), then the warm
# groups replay each signature once more
SERVE_MAX_BATCH = 4
SERVE_MIX = ((0, "alice", 1, None), (1, "bob", 1, None), (2, "carol", 1, None),
             (3, "alice", 1, None), (4, "bob", 1, None), (5, "carol", 1, None),
             (6, "alice", 1, None), (7, "bob", 1, None), (8, "alice", 2, None),
             (9, "bob", 1, 0.0))
SERVE_WARM = (((10, "alice", 1), (11, "bob", 1), (12, "alice", 1), (13, "bob", 1)),
              ((14, "alice", 1), (15, "bob", 1), (16, "alice", 1)),
              ((17, "bob", 2),))
SERVE_BATCHES = ((0, 1, 2, 3), (4, 6, 7), (8,), (10, 11, 12, 13), (14, 15, 16), (17,))
# the frontend phase: 6 concurrent clients, alternating batch 1 and 2, one
# request per batch (two stream signatures, captured while the clients run)
FRONTEND_IDS = tuple(range(100, 106))
FRONTEND_WAIT_S = 600.0


def _replay_entries(before: int) -> list:
    from repro_torch.api.compile import replay_cache_stats

    return replay_cache_stats()[before:]


def _batch_hooks(engine, records: list):
    """Zero the launch counters just before each batch attempt's execution
    and read them just after its outputs (``on_batch_attempt`` /
    ``on_batch_outputs``, the engine's transport hooks)."""
    from repro_torch.kernels import ops

    def attempt(admitted):
        torch.cuda.synchronize()
        ops.reset_launches()
        return [r.x for r in admitted]

    def outputs(admitted, outs):
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        counts["pack_ring_masked"] = ops.pack_ring.masked
        records.append({"ids": tuple(r.id for r in admitted), "counts": counts,
                        "xs": [r.x for r in admitted]})
        return outs

    engine.on_batch_attempt, engine.on_batch_outputs = attempt, outputs


def serve_phase():
    """The serving engine on full-width ResNet-18 (``RESNET18``, seeded
    weights at the reference's init scales) under the reduced plan, on the
    captured replay, with the default inline triples (``SERVE_MIX``, then
    ``SERVE_WARM``).  Requires: the batches ``SERVE_BATCHES``; each
    batch's rounds and bytes equal to its prediction (``simulate_merged``)
    and its rounds to the max over its requests; carol's second request
    failed with ``TripleBudgetExceeded`` and request 9 with
    ``DeadlineExceeded``, neither in any batch; every request's output
    shares equal to its serial oracle on the card (one stream,
    ``request_key(id)``, a fresh ``InlineTTP``; the captured replay for a
    single image, whose first call runs the generator loop and is checked
    against it at capture, the generator loop for the double); each batch
    launching its plan's kernels as often as its requests' plans say
    (``resnet_shape_launches`` per request: the streams are not merged),
    twice on a signature's first batch (the generator loop, then the
    capture) and never from the host on a warm one, whose graph holds
    them; each ReLU kernel equal to its plain version at the serving
    shapes.  Prints per batch its requests, rounds, bytes and synchronized
    wall, first call plus capture against warm, and the replay cache's
    entries, captures and reserved memory."""
    from repro_torch import api, errors, serve
    from repro_torch.core import beaver, comm as comm_lib, prng
    from repro_torch.core.mpc_tensor import MPCTensor
    from repro_torch.models import resnet

    cfg, params, plans, _, _ = resnet_setup()
    plan = plans["reduced"]

    def afn(p, x, relu_fn=None):
        return resnet.apply(p, x, cfg, relu_fn=relu_fn)

    need = sum(n for n, w in plan.triple_specs() if n and w)
    gen = torch.Generator().manual_seed(21)
    batch_of = {rid: b for rid, _, b, _ in SERVE_MIX}
    batch_of.update({rid: b for group in SERVE_WARM for rid, _, b in group})
    inputs = {rid: (torch.rand((b, 3, cfg.in_hw, cfg.in_hw), generator=gen) * 2 - 1)
              .cuda() for rid, b in sorted(batch_of.items())}
    engine = serve.InferenceEngine(afn, params, cfg, plan,
                                   api.Session(key=0, device="cuda"),
                                   policy=serve.BatchPolicy(max_batch=SERVE_MAX_BATCH),
                                   tenant_budgets={"carol": need})
    records = []
    _batch_hooks(engine, records)
    from repro_torch.api.compile import replay_cache_stats
    cache0, mem0 = len(replay_cache_stats()), torch.cuda.memory_reserved()
    os.environ["HB_ROUND_LOOP"] = "scan"
    t0 = time.perf_counter()
    futs = {rid: engine.submit(t, inputs[rid], request_id=rid, deadline_s=d)
            for rid, t, _, d in SERVE_MIX}
    engine.flush()
    for group in SERVE_WARM:
        futs.update({rid: engine.submit(t, inputs[rid], request_id=rid)
                     for rid, t, _ in group})
        engine.flush()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    entries, mem1 = _replay_entries(cache0), torch.cuda.memory_reserved()
    reports = list(engine.reports)
    if tuple(r.request_ids for r in reports) != SERVE_BATCHES or \
            tuple(r["ids"] for r in records) != SERVE_BATCHES:
        raise AssertionError(f"serve: batches {[r.request_ids for r in reports]}, "
                             f"expected {SERVE_BATCHES}")
    for rid, exc in ((5, errors.TripleBudgetExceeded), (9, errors.DeadlineExceeded)):
        try:
            futs[rid].result()
        except exc:
            pass
        else:
            raise AssertionError(f"serve: request {rid} did not fail with {exc.__name__}")
    usage = engine.tenant_usage("carol")
    if usage["consumed_elements"] != need or engine.stats()["shed"] != 1:
        raise AssertionError(f"serve: carol consumed {usage}, shed "
                             f"{engine.stats()['shed']}; expected {need}, 1")
    seen, rows_out, by_shape, host = set(), [], {k: {} for k in SHAPE_KERNELS}, {}
    for rep, rec in zip(reports, records):
        sig = rep.shapes
        plan_rounds = max(engine.plan_for_shape(s).schedule().n_rounds for s in sig)
        if (rep.measured_rounds, rep.measured_bytes) != \
                (rep.predicted_rounds, rep.predicted_bytes) or \
                rep.measured_rounds != plan_rounds:
            raise AssertionError(f"serve batch {rep.request_ids}: measured "
                                 f"{rep.measured_rounds} rounds / {rep.measured_bytes}"
                                 f" B, predicted {rep.predicted_rounds} / "
                                 f"{rep.predicted_bytes}, max over requests "
                                 f"{plan_rounds}")
        shapes = {k: {} for k in SHAPE_KERNELS}
        for s in sig:
            resnet_shape_launches(engine.plan_for_shape(s), streams=1, batch=s[0],
                                  out=shapes)
            resnet_shape_launches(engine.plan_for_shape(s), streams=1, batch=s[0],
                                  out=by_shape)
        per = {k: sum(v.values()) for k, v in shapes.items()}
        per["pack_ring_masked"] = per["pack_ring"]
        counts = rec["counts"]
        first = sig not in seen
        seen.add(sig)
        stats = engine.model.replay_stats(rec["xs"])
        if stats is None or any(stats["launches"][k] != v for k, v in per.items()):
            raise AssertionError(f"serve batch {rep.request_ids}: its graph holds "
                                 f"{stats and stats['launches']}, its plans say {per}")
        want = {k: (2 * v if first else 0) for k, v in per.items()}
        if any(counts[k] != v for k, v in want.items()):
            raise AssertionError(f"serve batch {rep.request_ids}: launched {counts}, "
                                 f"expected {want} ({'first call and capture' if first else 'warm replay'})")
        if first and {k for k, v in counts.items()
                      if v and k != "pack_ring_masked"} != PATH_KERNELS["reduced"]:
            raise AssertionError(f"serve batch {rep.request_ids}: launched "
                                 f"{counts}, its path runs {PATH_KERNELS['reduced']}")
        for k, v in counts.items():
            host[k] = host.get(k, 0) + v
        rows_out.append({"ids": list(rep.request_ids), "tenants": list(rep.tenants),
                         "shapes": [list(s) for s in sig], "first": first,
                         "rounds": rep.measured_rounds, "bytes": rep.measured_bytes,
                         "serial_rounds": rep.serial_rounds,
                         "rounds_saved_ratio": rep.rounds_saved_ratio,
                         "wall_s": rep.wall_s, "launches": counts,
                         "captured_launches": stats["launches"],
                         "trace_s": stats["trace_s"], "compile_s": stats["compile_s"]})
        print(f"serve batch {list(rep.request_ids)} ({len(sig)} requests, shapes "
              f"{[s[0] for s in sig]} x 3x32x32): {rep.measured_rounds} rounds, "
              f"{rep.measured_bytes} B (= predicted), rounds saved "
              f"{rep.rounds_saved_ratio:.2f}x, synchronized wall {rep.wall_s:.4f} s "
              f"({'first call: generator loop + capture ' + format(stats['trace_s'], '.3f') + ' s + instantiation and first replay ' + format(stats['compile_s'], '.3f') + ' s' if first else 'warm replay'}); "
              f"host launches {sum(v for k, v in counts.items() if k != 'pack_ring_masked')}, "
              f"captured {sum(v for k, v in stats['launches'].items() if k != 'pack_ring_masked')}",
              flush=True)
    # every request against its serial oracle on the card
    oracle = api.compile(afn, params, cfg, plan, api.Session(key=0, device="cuda"))
    t0 = time.perf_counter()
    for rid in sorted(r for rep in reports for r in rep.request_ids):
        enc_key, key = prng.split(oracle.session.request_key(rid))
        X = MPCTensor.from_plain(enc_key, inputs[rid])
        os.environ["HB_ROUND_LOOP"] = "scan" if batch_of[rid] == 1 else "python"
        want = oracle._run_streams([X], [iter(prng.split(key, 256))],
                                   [beaver.InlineTTP()], comm_lib.CoalescingComm(),
                                   params, auto_batch=False)[0]
        if not torch.equal(futs[rid].result().data, want.data):
            raise AssertionError(f"serve: request {rid}'s shares differ from its "
                                 "serial oracle")
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    os.environ.pop("HB_ROUND_LOOP", None)
    rows, records_s = _timed(lambda: search_kernel_phase(by_shape, path="serve"))
    stats = engine.stats()
    first_walls = [r["wall_s"] for r in rows_out if r["first"]]
    warm_walls = [r["wall_s"] for r in rows_out if not r["first"]]
    out = {"plan": "reduced", "max_batch": SERVE_MAX_BATCH, "carol_budget": need,
           "batches": rows_out, "drain_s": drain_s, "oracle_s": oracle_s,
           "kernel_records_s": records_s, "stats": stats,
           "replay_entries_built": len(entries), "replay_entries": entries,
           "memory_reserved_before": mem0, "memory_reserved_after": mem1,
           "launches_by_shape": {k: {str(s): n for s, n in v.items()}
                                 for k, v in by_shape.items()}}
    print(f"serve: {len(reports)} batches ({stats['requests']} requests, 1 over "
          f"budget, 1 shed) drained in {drain_s:.3f} s; engine rounds_saved_ratio "
          f"{stats['rounds_saved_ratio']:.3f}; first batch of each signature "
          f"{[round(w, 4) for w in first_walls]} s, warm {[round(w, 4) for w in warm_walls]}"
          f" s; every request's shares equal its serial oracle ({oracle_s:.3f} s); "
          f"replay cache: {len(entries)} entries built "
          f"{[(round(e['trace_s'], 3), round(e['compile_s'], 3), e['n_rounds']) for e in entries]}"
          f" (trace_s, compile_s, rounds), memory reserved {mem0} -> {mem1} B",
          flush=True)
    return out, rows, host


def serve_lm_phase(lm_setup_):
    """The private LM (``LM_ARCH`` at full width, ``LM_LAYERS`` layers) served
    by an engine built with ``apply_fn=None`` on the exact plan: the
    ``LM_STREAMS`` requests of ``LM_SEQ`` embedded tokens as one batch on
    the generator loop (a plan with opens never runs on the replay).
    Requires: rounds and bytes equal to the engine's merged schedule (the
    ReLU rows merged by ``simulate_merged``, each product site's opens in
    one round by ``simulate_open``) and to ``plan.schedule(streams=2,
    auto_batch=False)``, the rounds to ``LM_SCHEDULE``'s; the plan's
    kernels as often as its per-stream shapes say (``lm_shape_launches``
    unmerged); each request's logits within the exact plan's tolerance of
    the plaintext twin."""
    from repro_torch import api, serve

    cfg, params, plans, hs, want = lm_setup_
    plan = plans["lm-exact"]
    engine = serve.InferenceEngine(None, params, cfg, plan,
                                   api.Session(key=0, device="cuda"))
    records = []
    _batch_hooks(engine, records)
    futs = [engine.submit(t, h, request_id=i)
            for i, (t, h) in enumerate(zip(("alice", "bob"), hs))]
    t0 = time.perf_counter()
    engine.flush()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    (rep,), (rec,) = list(engine.reports), records
    sched = plan.schedule(streams=LM_STREAMS, auto_batch=False)
    if rep.n_requests != LM_STREAMS or \
            (rep.measured_rounds, rep.measured_bytes) != \
            (rep.predicted_rounds, rep.predicted_bytes) or \
            (rep.measured_rounds, rep.measured_bytes) != \
            (sched.n_rounds, sched.bytes_tx) or \
            rep.measured_rounds != LM_SCHEDULE["lm-exact"][0]:
        raise AssertionError(f"serve-lm: {rep.n_requests} requests, measured "
                             f"{rep.measured_rounds} rounds / {rep.measured_bytes} B, "
                             f"predicted {rep.predicted_rounds} / "
                             f"{rep.predicted_bytes}, schedule {sched.n_rounds} / "
                             f"{sched.bytes_tx}, expected {LM_SCHEDULE['lm-exact'][0]} "
                             "rounds")
    per = {k: sum(v.values()) for k, v in
           lm_shape_launches(plan, lm_setup_, merged=False).items()}
    counts = rec["counts"]
    launched = {k for k, v in counts.items() if v and k != "pack_ring_masked"}
    if launched != PATH_KERNELS["lm-exact"] or \
            counts["pack_ring_masked"] != counts["pack_ring"] or \
            any(counts[k] != v for k, v in per.items()):
        raise AssertionError(f"serve-lm: launched {counts}, its plan says {per}")
    got = torch.cat([f.result().reveal() for f in futs])
    err, limit = float((got - want).abs().max()), ATOL + RTOL * float(want.abs().max())
    if not torch.isfinite(got).all() or got.shape != want.shape or err > limit:
        raise AssertionError(f"serve-lm: logits {tuple(got.shape)}, max error {err} "
                             f"vs the plaintext twin, limit {limit}")
    out = {"plan": "lm-exact", "requests": rep.n_requests,
           "rounds": rep.measured_rounds, "bytes": rep.measured_bytes,
           "main_path_bytes_auto_batched": LM_SCHEDULE["lm-exact"][1],
           "wall_s": rep.wall_s, "drain_s": drain_s, "launches": counts,
           "max_abs_err_vs_plaintext": err, "err_limit": limit}
    print(f"serve-lm ({LM_ARCH}, {LM_LAYERS} layers, {LM_STREAMS} requests of "
          f"{LM_SEQ} tokens, one batch on the generator loop, inline triples): "
          f"{rep.measured_rounds} rounds, {rep.measured_bytes} B (= the merged "
          f"schedule; the main path's auto-batched call: "
          f"{LM_SCHEDULE['lm-exact'][1]} B), synchronized wall {rep.wall_s:.4f} s, "
          f"launches {counts}, max |logit - plaintext| {err:.4g} (limit {limit:.4g})",
          flush=True)
    return out, counts


def frontend_phase():
    """The HTTP frontend over a ResNet-18 engine (reduced plan,
    ``BatchPolicy(max_batch=1)``) with a fresh replay cache, so that the
    pump captures while the clients run: ``len(FRONTEND_IDS)`` concurrent
    ``POST /infer`` from threads (``urllib``), batch 1 and 2 in turn, with
    explicit request ids, then ``GET /healthz`` and ``GET /stats``.
    Requires: every reply's ``y`` equal to the reveal of the same request
    id on a direct engine; no pump error; at least one capture during the
    phase; the path's kernels launched; every wait bounded by a timeout.
    The launch counters are zeroed before the frontend starts and read
    after it closes."""
    import json as json_lib
    import threading
    import urllib.request

    import numpy as np

    from repro_torch import api, serve
    from repro_torch.api.compile import _REPLAY_CACHE, replay_cache_stats
    from repro_torch.kernels import ops
    from repro_torch.models import resnet

    cfg, params, plans, _, _ = resnet_setup()
    plan = plans["reduced"]

    def afn(p, x, relu_fn=None):
        return resnet.apply(p, x, cfg, relu_fn=relu_fn)

    _REPLAY_CACHE.clear()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_reserved()
    gen = torch.Generator().manual_seed(31)
    xs = {rid: torch.rand((1 + i % 2, 3, cfg.in_hw, cfg.in_hw), generator=gen) * 2 - 1
          for i, rid in enumerate(FRONTEND_IDS)}
    os.environ["HB_ROUND_LOOP"] = "scan"
    engine = serve.InferenceEngine(afn, params, cfg, plan,
                                   api.Session(key=0, device="cuda"),
                                   policy=serve.BatchPolicy(max_batch=1))
    torch.cuda.synchronize()
    ops.reset_launches()
    frontend = serve.Frontend(engine)
    host, port = frontend.serve_background("127.0.0.1", 0)
    base = f"http://{host}:{port}"

    def http(method, path, body=None):
        req = urllib.request.Request(
            base + path, method=method,
            data=json_lib.dumps(body).encode() if body is not None else None)
        with urllib.request.urlopen(req, timeout=FRONTEND_WAIT_S) as resp:
            return resp.status, json_lib.loads(resp.read().decode())

    replies, failures = {}, {}

    def client(rid):
        try:
            replies[rid] = http("POST", "/infer", {
                "tenant": f"tenant{rid % 3}", "x": xs[rid].tolist(),
                "request_id": rid, "timeout_s": FRONTEND_WAIT_S})
        except Exception as e:              # noqa: BLE001 (reported below)
            failures[rid] = repr(e)

    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(rid,)) for rid in FRONTEND_IDS]
        for t in threads:
            t.start()
        for t in threads:
            t.join(FRONTEND_WAIT_S)
        wall_s = time.perf_counter() - t0
        alive = [t.name for t in threads if t.is_alive()]
        _, health = http("GET", "/healthz")
        _, stats = http("GET", "/stats")
    finally:
        frontend.close()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    counts["pack_ring_masked"] = ops.pack_ring.masked
    entries = replay_cache_stats()
    mem1 = torch.cuda.memory_reserved()
    if alive or failures or engine.pump_running:
        raise AssertionError(f"frontend: clients alive {alive}, failed {failures}, "
                             f"pump running {engine.pump_running}")
    if health["last_pump_error"] is not None or engine.last_pump_error is not None:
        raise AssertionError(f"frontend: pump error {health['last_pump_error']}")
    if not entries:
        raise AssertionError("frontend: nothing was captured during the phase")
    launched = {k for k, v in counts.items() if v and k != "pack_ring_masked"}
    if launched != PATH_KERNELS["reduced"]:
        raise AssertionError(f"frontend: launched {counts}, its path runs "
                             f"{sorted(PATH_KERNELS['reduced'])}")
    if stats["requests"] != len(FRONTEND_IDS) or \
            stats["frontend_requests"] != len(FRONTEND_IDS):
        raise AssertionError(f"frontend: /stats {stats}")
    direct = serve.InferenceEngine(afn, params, cfg, plan,
                                   api.Session(key=0, device="cuda"),
                                   policy=serve.BatchPolicy(max_batch=1))
    dfuts = {rid: direct.submit(f"tenant{rid % 3}", xs[rid], request_id=rid)
             for rid in FRONTEND_IDS}
    direct.flush()
    batches = []
    for rid in FRONTEND_IDS:
        status, reply = replies[rid]
        want = dfuts[rid].result().reveal().cpu().numpy()
        if status != 200 or reply["id"] != rid or \
                not np.array_equal(np.asarray(reply["y"], np.float32), want):
            raise AssertionError(f"frontend: request {rid} answered {status} "
                                 f"{reply.get('id')}, y differs from the direct engine")
        batches.append(reply["batch"])
    os.environ.pop("HB_ROUND_LOOP", None)
    out = {"requests": len(FRONTEND_IDS), "wall_s": wall_s, "stats": stats,
           "healthz": health, "launches": counts, "replay_entries": entries,
           "memory_reserved_before": mem0, "memory_reserved_after": mem1,
           "batches": batches}
    print(f"frontend: {len(FRONTEND_IDS)} concurrent POST /infer (batch 1 and 2 in "
          f"turn, one request per batch) answered in {wall_s:.3f} s, every y equal "
          f"to the direct engine's reveal; {len(entries)} replays captured while "
          f"the clients ran {[(round(e['trace_s'], 3), round(e['compile_s'], 3)) for e in entries]}"
          f" (trace_s, compile_s); /healthz last_pump_error None; /stats requests "
          f"{stats['requests']}, rounds_saved_ratio {stats['rounds_saved_ratio']:.3f};"
          f" memory reserved {mem0} -> {mem1} B; launches {counts}", flush=True)
    return out, counts


def seed_oracle_phase():
    """The frozen seed oracle (``core/gmw_ref.py``) against the fused engine
    on the card: ``gmw_ref.relu`` at the stem's shape (one stream, 65 536
    elements) at (64, 0), (21, 13) and (21, 13) with the cone must equal
    ``gmw.relu`` bit for bit, and launch only ``beaver_and`` (in its plain
    form), once per AND; both paths' exchanges (``CountingComm``) and
    synchronized walls printed (a check, not a benchmark).  Then
    ``BENCH_relu.json``'s ``multigroup``: through the seed oracle one group
    after another (31 swaps, 696 576 B) and through ``gmw.relu_many``
    fused (10 rounds, 696 576 B), with the same keys and triples per group:
    the same shares, hence the same reveals."""
    from repro_torch.core import beaver, comm as comm_lib, fixed, gmw, gmw_ref, prng, \
        schedule, shares
    from repro_torch.kernels import ops

    def shared(n, seed):
        gen = torch.Generator().manual_seed(seed)
        x = (torch.rand((n,), generator=gen) * 7.8 - 3.9).cuda()
        return shares.share(prng.PRNGKey(seed, "cuda"), fixed.encode(x))

    def run(fn, comm):
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        out = fn(comm)
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        return out, time.perf_counter() - t0, counts

    n = RELU_GROUPS[0][0]
    x = shared(n, 41)
    cases, seed_launches = [], {}
    for name, k, m, cone in (("exact", 64, 0, False), ("reduced", 21, 13, False),
                             ("reduced-cone", 21, 13, True)):
        tri = beaver.gen_relu_triples(prng.PRNGKey(42, "cuda"), n, k - m, cone=cone)
        key = prng.PRNGKey(43, "cuda")
        cm_s, cm_f = comm_lib.CountingComm(), comm_lib.CountingComm()
        seed, seed_s, seed_counts = run(
            lambda c: gmw_ref.relu(key, x, tri, c, k=k, m=m, cone=cone), cm_s)
        fused, fused_s, fused_counts = run(
            lambda c: gmw.relu(key, x, tri, c, k=k, m=m, cone=cone), cm_f)
        ands = schedule.stream_rounds(k - m, cone=cone) - 3   # less A2B, B2A, mult
        if not torch.equal(seed, fused):
            raise AssertionError(f"seed-oracle {name}: shares differ from gmw.relu")
        if seed_counts != {"beaver_and": ands}:
            raise AssertionError(f"seed-oracle {name}: launched {seed_counts}, the "
                                 f"seed path runs beaver_and {ands} times")
        for kn, v in seed_counts.items():
            seed_launches[kn] = seed_launches.get(kn, 0) + v
        cases.append({"name": name, "k": k, "m": m, "cone": cone, "n": n,
                      "seed_swaps": cm_s.n_swaps, "seed_bytes": cm_s.bytes_tx,
                      "fused_swaps": cm_f.n_swaps, "fused_bytes": cm_f.bytes_tx,
                      "seed_wall_s": seed_s, "fused_wall_s": fused_s,
                      "seed_launches": seed_counts, "fused_launches": fused_counts})
        print(f"seed-oracle {name} ({k}, {m}) at {n} elements: shares equal the fused "
              f"engine's; seed {cm_s.n_swaps} exchanges / {cm_s.bytes_tx} B in "
              f"{seed_s:.4f} s (launches {seed_counts}), fused {cm_f.n_swaps} / "
              f"{cm_f.bytes_tx} B in {fused_s:.4f} s (launches {fused_counts})",
              flush=True)
    groups = json.load(open(os.path.join(ROOT, "BENCH_relu.json")))["multigroup"]["groups"]
    specs = [(g["n"], g["k"], g["m"]) for g in groups]
    xs = [shared(gn, 50 + i) for i, (gn, _, _) in enumerate(specs)]
    trs = [beaver.gen_relu_triples(prng.PRNGKey(60 + i, "cuda"), gn, gk - gm)
           for i, (gn, gk, gm) in enumerate(specs)]
    keys = [prng.PRNGKey(40 + i, "cuda") for i in range(len(specs))]
    cm, cc = comm_lib.CountingComm(), comm_lib.CoalescingComm()
    seed, seed_s, seed_counts = run(
        lambda c: [gmw_ref.relu(kk, xx, tt, c, k=gk, m=gm)
                   for kk, xx, tt, (_, gk, gm) in zip(keys, xs, trs, specs)], cm)
    fused, fused_s, fused_counts = run(
        lambda c: gmw.relu_many(keys, xs, trs, c, [(gk, gm) for _, gk, gm in specs]), cc)
    for kn, v in seed_counts.items():
        seed_launches[kn] = seed_launches.get(kn, 0) + v
    if (cm.n_swaps, cm.bytes_tx, cc.n_rounds, cc.bytes_tx) != (31, 696576, 10, 696576):
        raise AssertionError(f"multigroup: seed {cm.n_swaps} swaps / {cm.bytes_tx} B, "
                             f"fused {cc.n_rounds} / {cc.bytes_tx}; expected 31 / "
                             "696576, 10 / 696576")
    for s, f in zip(seed, fused):
        if not torch.equal(s, f) or not torch.equal(
                fixed.decode(shares.reconstruct(s)), fixed.decode(shares.reconstruct(f))):
            raise AssertionError("multigroup: the seed and the fused outputs differ")
    multigroup = {"groups": groups, "swaps_seed": cm.n_swaps, "bytes_seed": cm.bytes_tx,
                  "swaps_fused": cc.n_rounds, "bytes_fused": cc.bytes_tx,
                  "seed_wall_s": seed_s, "fused_wall_s": fused_s,
                  "seed_launches": seed_counts, "fused_launches": fused_counts}
    print(f"seed-oracle multigroup {specs}: seed {cm.n_swaps} swaps / {cm.bytes_tx} B "
          f"in {seed_s:.4f} s, fused {cc.n_rounds} rounds / {cc.bytes_tx} B in "
          f"{fused_s:.4f} s; same shares and reveals", flush=True)
    return {"stem": cases, "multigroup": multigroup}, seed_launches


# ---------------------------------------------------------------------------
# deploy: two parties, each with only its own share rows (P = 1 kernels)
# ---------------------------------------------------------------------------

# one input tensor of DEPLOY_BATCH images per call (the plans traced at that
# batch, one stream); the in-process fault plan's transient events; party
# 0's kill after DEPLOY_DIE_AFTER live rounds, journals snapshotted every
# DEPLOY_SNAPSHOT_EVERY rounds; the engine link's requests (id, tenant) in
# submission order, batched by DEPLOY_LINK_MAX_BATCH so no tenant meets
# itself in a batch; every wait on a thread or a party process bounded
DEPLOY_BATCH = 4
DEPLOY_PLANS = ("exact", "reduced")
DEPLOY_FAULTS = dict(drops=2, corrupts=2)
DEPLOY_DIE_AFTER, DEPLOY_SNAPSHOT_EVERY = 20, 10
DEPLOY_LINK_REQUESTS = ((300, "alice"), (301, "bob"), (302, "alice"))
DEPLOY_LINK_MAX_BATCH = 2
DEPLOY_TTP_SEED = 17
DEPLOY_WAIT_S = 300.0
# each timed kernel's source and the TPU kernel it replaces
SOURCES = {k: "src/repro_torch/csrc/gmw_round.cu"
           for k in ("beaver_and", "ks_mask", "ks_combine", "ks_step")}
SOURCES.update(pack_ring="src/repro_torch/csrc/bitpack.cu",
               unpack="src/repro_torch/csrc/bitpack.cu",
               ring_matmul="src/repro_torch/csrc/ring_matmul.cu")
REPLACES = {"beaver_and": "src/repro/kernels/gmw_round.py:45",
            "ks_mask": "src/repro/kernels/gmw_round.py:73",
            "ks_combine": "src/repro/kernels/gmw_round.py:105",
            "ks_step": "src/repro/kernels/gmw_round.py:105",
            "pack_ring": "src/repro/kernels/bitpack.py:44",
            "unpack": "src/repro/kernels/bitpack.py:60",
            "ring_matmul": "src/repro/kernels/ring_matmul.py:88"}


def deploy_setup():
    """Full-width ResNet-18 (seeded weights, ``resnet.init(cfg, seed=0)``,
    as a party host derives them), its exact and reduced plans traced at
    batch ``DEPLOY_BATCH``, one input's shares, the plaintext logits and one
    call's triple pool per plan (offline, timed apart)."""
    from repro_torch.configs import RESNET18
    from repro_torch.core import beaver, prng
    from repro_torch.core.hummingbird import HBConfig, HBLayer
    from repro_torch.core.mpc_tensor import MPCTensor
    from repro_torch.models import resnet

    cfg = RESNET18
    params = resnet.init(cfg, seed=0, device="cuda")
    exact = resnet.trace(params, cfg, batch=DEPLOY_BATCH)
    plans = {"exact": exact, "reduced": exact.with_hb(HBConfig(
        tuple([HBLayer(k=21, m=13)] * (exact.n_groups - 1) + [HBLayer(k=13, m=13)]),
        exact.group_elements))}
    gen = torch.Generator().manual_seed(5)
    x = (torch.rand((DEPLOY_BATCH, 3, cfg.in_hw, cfg.in_hw), generator=gen) * 2
         - 1).cuda()
    X = MPCTensor.from_plain(prng.PRNGKey(2, "cuda"), x)
    with torch.no_grad():
        want = resnet.ResNet(params, cfg)(x)
    pools, offline = {}, {}
    for name in DEPLOY_PLANS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pools[name] = beaver.gen_plan_triples(prng.PRNGKey(3, "cuda"),
                                              plans[name].triple_specs())
        torch.cuda.synchronize()
        offline[name] = time.perf_counter() - t0
        print(f"deploy {name}: one call's triple pool in {offline[name]:.3f} s",
              flush=True)
    return {"cfg": cfg, "params": params, "plans": plans, "X": X, "want": want,
            "pools": pools, "offline_s": offline}


def _deploy_afn(cfg):
    from repro_torch.models import resnet

    def afn(p, v, relu_fn=None):
        return resnet.apply(p, v, cfg, relu_fn=relu_fn)
    return afn


def _deploy_counts():
    from repro_torch.kernels import ops

    counts = ops.launch_counts()
    counts["pack_ring_masked"] = ops.pack_ring.masked
    return counts


def deploy_party_launches(plan) -> dict:
    """One party's launches per kernel in one deploy call, read from the
    plan (``resnet_shape_launches`` of one stream; ring_matmul's M is one
    party's rows, twice the main path's per-request M)."""
    by_shape = resnet_shape_launches(plan, streams=1, batch=2)
    return {k: sum(v.values()) for k, v in by_shape.items()}


def _deploy_sim(name, s):
    """The single-process oracle: ``SimComm`` on the generator loop on the
    card, the same shares, pool and key; its rounds and bytes equal to the
    schedule, its launches to one party's, its reveal checked."""
    from repro_torch import api
    from repro_torch.core import beaver, comm as comm_lib, prng
    from repro_torch.kernels import ops

    plan = s["plans"][name]
    os.environ["HB_ROUND_LOOP"] = "python"
    cc = comm_lib.CoalescingComm(comm_lib.SimComm())
    session = api.Session(key=0, comm=cc, device="cuda",
                          provider=beaver.TriplePool(s["pools"][name]))
    model = api.compile(_deploy_afn(s["cfg"]), s["params"], s["cfg"], plan, session)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = model(s["X"], key=prng.PRNGKey(4, "cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _deploy_counts()
    errs = []
    _check_call(name, {"rounds": cc.n_rounds, "bytes": cc.bytes_tx, "outs": [out]},
                plan.schedule(), s["want"], errs)
    want = deploy_party_launches(plan)
    if {k: counts[k] for k in want} != want or \
            {k for k in want if counts[k]} != PATH_KERNELS[name] or \
            counts["pack_ring_masked"] != counts["pack_ring"]:
        raise AssertionError(f"deploy {name} SimComm: launches {counts}, the plan "
                             f"says {want}")
    return {"out": out, "wall": wall, "counts": counts, "max_err": errs[0]}


def _deploy_faults(s, sim):
    """(a) The reduced plan on ``SimComm`` under
    ``Session.resilient(fault_plan=FaultPlan.seeded(...))``: shares equal to
    the clean run's, every transient event recovered, framed rounds and
    bytes equal to ``Schedule.framed()``."""
    from repro_torch import api
    from repro_torch.core import beaver, faults, prng

    plan = s["plans"]["reduced"]
    framed = plan.schedule().framed()
    fault_plan = faults.FaultPlan.seeded(11, framed.n_rounds, **DEPLOY_FAULTS)
    session = api.Session(key=0, device="cuda",
                          provider=beaver.TriplePool(s["pools"]["reduced"]))
    session.resilient(fault_plan=fault_plan)
    model = api.compile(_deploy_afn(s["cfg"]), s["params"], s["cfg"], plan, session)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model(s["X"], key=prng.PRNGKey(4, "cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rc = session.comm
    _same_shares("deploy faults", [out], [sim["reduced"]["out"]],
                 "shares differ from the clean run")
    if (rc.recovered, rc.retries) != (fault_plan.n_transient,) * 2 or \
            rc.base.injected != {"drop": 2, "stall": 0, "corrupt": 2, "crash": 0}:
        raise AssertionError(f"deploy faults: recovered {rc.recovered}, retries "
                             f"{rc.retries}, injected {rc.base.injected}, plan "
                             f"{fault_plan.n_transient} transient")
    if (rc.n_rounds, rc.round_bytes) != (framed.n_rounds, list(framed.round_bytes)):
        raise AssertionError(f"deploy faults: {rc.n_rounds} rounds / "
                             f"{rc.bytes_tx} B != framed {framed.n_rounds} / "
                             f"{framed.bytes_tx}")
    rec = {"events": [vars(e) for e in fault_plan.events], "wall_s": wall,
           "recovered": rc.recovered, "resent_bytes": rc.resent_bytes,
           "faults_detected": dict(rc.faults_detected),
           "framed_rounds": rc.n_rounds, "framed_bytes": rc.bytes_tx,
           "sim_wall_s": sim["reduced"]["wall"]}
    print(f"deploy (a) faults, reduced: {rc.recovered} of "
          f"{fault_plan.n_transient} transient events recovered "
          f"({rc.faults_detected}), {rc.n_rounds} framed rounds / {rc.bytes_tx} B "
          f"== Schedule.framed(); {wall:.3f} s against the clean SimComm call's "
          f"{sim['reduced']['wall']:.3f} s; shares equal", flush=True)
    return rec


def _run_threads(fns, timeout_s=DEPLOY_WAIT_S):
    """Run each callable on its own thread; re-raise the first failure,
    fail on a thread still running after ``timeout_s``."""
    import threading

    results, errs = {}, {}

    def wrap(i, fn):
        try:
            results[i] = fn()
        except BaseException as e:     # noqa: BLE001 (re-raised below)
            errs[i] = e

    threads = [threading.Thread(target=wrap, args=(i, f), daemon=True)
               for i, f in enumerate(fns)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    if errs:
        raise next(iter(errs.values()))
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"a party thread still runs after {timeout_s} s")
    return [results[i] for i in range(len(fns))]


def _two_party_threads(name, s, shaper=None):
    """(b) Both parties as threads of this process over localhost
    ``Session.connect``, each with its own rows and its slice of the pool;
    returns (outputs, sessions, per-party walls, launch counts)."""
    from repro_torch import api
    from repro_torch.core import beaver, prng
    from repro_torch.core.mpc_tensor import MPCTensor
    from repro_torch.kernels import ops
    from repro_torch.transport import free_port

    plan, X = s["plans"][name], s["X"]
    port = free_port()

    def party(i):
        session = api.Session.connect(
            i, listen=("127.0.0.1", port) if i == 0 else None,
            peer=("127.0.0.1", port) if i == 1 else None, key=0,
            session_id=f"deploy-{name}", plan_digest=plan.digest(),
            provider=beaver.TriplePool(beaver.slice_party_pool(s["pools"][name], i)),
            shaper=shaper, timeout_s=DEPLOY_WAIT_S,
            handshake_timeout_s=DEPLOY_WAIT_S, device="cuda")
        model = api.compile(_deploy_afn(s["cfg"]), s["params"], s["cfg"], plan,
                            session)
        xi = MPCTensor(X.data[i:i + 1], X.frac_bits)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(xi, key=prng.PRNGKey(4, "cuda"))
        torch.cuda.synchronize()
        return out, session, time.perf_counter() - t0

    torch.cuda.synchronize()
    ops.reset_launches()
    res = _run_threads([lambda: party(0), lambda: party(1)])
    torch.cuda.synchronize()
    counts = _deploy_counts()
    for _, session, _ in res:
        session.transport.close()
    return [r[0] for r in res], [r[1] for r in res], [r[2] for r in res], counts


def _check_two_party(what, name, s, sim, outs, sessions, counts=None):
    """Combined shares equal to the SimComm run's; each party's socket and
    ``ResilientComm`` rounds and bytes equal to ``Schedule.framed()``; with
    ``counts``, every path kernel launched twice one party's count."""
    from repro_torch.core import comm as comm_lib
    from repro_torch.core.mpc_tensor import MPCTensor

    combined = MPCTensor(torch.cat([o.data for o in outs]), outs[0].frac_bits)
    _same_shares(f"deploy {what} {name}", [combined], [sim[name]["out"]],
                 "two-party shares differ from the SimComm run's")
    framed = s["plans"][name].schedule().framed()
    for i, session in enumerate(sessions):
        sock, rc = session.transport, comm_lib.find_resilient(session.comm)
        for layer, got in (("socket", sock), ("resilient", rc)):
            if (got.n_rounds, list(got.round_bytes)) != \
                    (framed.n_rounds, list(framed.round_bytes)):
                raise AssertionError(
                    f"deploy {what} {name} party {i} {layer}: {got.n_rounds} "
                    f"rounds / {got.bytes_tx} B != framed {framed.n_rounds} / "
                    f"{framed.bytes_tx}")
    if counts is not None:
        want = {k: 2 * v for k, v in deploy_party_launches(s["plans"][name]).items()}
        if {k: counts[k] for k in want} != want or \
                {k for k in want if counts[k]} != PATH_KERNELS[name]:
            raise AssertionError(f"deploy {what} {name}: launches {counts}, "
                                 f"twice one party's is {want}")
    return framed


def _deploy_threads(s, sim):
    """(b) exact and reduced as two threads, unshaped (kernel launches
    counted: twice one party's) and shaped to the LAN preset; each
    party's wall beside the SimComm call's, ``Schedule.latency`` and
    ``wall_band``."""
    from repro_torch.api.plan import NETWORKS
    from repro_torch.transport import LinkShaper

    lan = NETWORKS["lan"]
    rec, total = {}, {k: 0 for k in SHAPE_KERNELS}
    for name in DEPLOY_PLANS:
        outs, sessions, walls, counts = _two_party_threads(name, s)
        framed = _check_two_party("threads", name, s, sim, outs, sessions, counts)
        for k in SHAPE_KERNELS:
            total[k] += counts[k]
        outs, sessions, lan_walls, _ = _two_party_threads(
            name, s, LinkShaper.from_preset(lan))
        _check_two_party("threads (LAN)", name, s, sim, outs, sessions)
        latency = framed.latency(lan.bandwidth_bps, lan.rtt_s)
        band = framed.wall_band(lan.bandwidth_bps, lan.rtt_s)
        if not all(band[0] <= w <= band[1] for w in lan_walls):
            raise AssertionError(f"deploy {name} LAN walls {lan_walls} outside the "
                                 f"schedule's band {band}")
        rec[name] = {"party_wall_s": walls, "lan_party_wall_s": lan_walls,
                     "sim_wall_s": sim[name]["wall"], "framed_rounds": framed.n_rounds,
                     "framed_bytes": framed.bytes_tx, "lan_latency_s": latency,
                     "lan_wall_band_s": band, "launches": counts,
                     "sim_max_err": sim[name]["max_err"]}
        print(f"deploy (b) {name}: two party threads {walls[0]:.3f} / "
              f"{walls[1]:.3f} s unshaped, {lan_walls[0]:.3f} / {lan_walls[1]:.3f} s "
              f"on the LAN preset (Schedule.latency {latency:.3f} s, wall_band "
              f"[{band[0]:.3f}, {band[1]:.3f}] s); SimComm {sim[name]['wall']:.3f} s; "
              f"{framed.n_rounds} framed rounds / {framed.bytes_tx} B a party; "
              f"shares equal; launches twice one party's", flush=True)
    return rec, total


def _journal_writes(round_bytes, die, every, last):
    """Bytes of journal payload each party writes in (c) (npz headers
    aside), from the schedule's round sizes (one party's rows): party 0
    snapshots at every multiple of ``every`` up to ``die``; party 1 also
    once more at the crash; the relaunch snapshots at each multiple past
    ``die`` up to ``last``."""
    cum = [0]
    for b in round_bytes:
        cum.append(cum[-1] + b)
    first = sum(cum[r] for r in range(every, die + 1, every))
    again = sum(cum[r] for r in range(die + every, last + 1, every)
                if r > die)
    return {"party0": first + again, "party1": first + cum[die] + again}


def _deploy_processes(s, sim):
    """(c) ``python -m repro_torch.launch.party_host`` twice over a job
    directory written by ``write_job`` (reduced plan): a clean run, then a
    kill of party 0 after ``DEPLOY_DIE_AFTER`` rounds with journals, and
    the relaunch resumed from them; outputs equal to (b)'s."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.core import ring
    from repro_torch.transport import free_port, job, write_job

    plan = s["plans"]["reduced"]
    base = os.path.join(ROOT, "build")
    os.makedirs(base, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="deploy_", dir=base)
    jobdir = os.path.join(tmp, "job")
    try:
        t0 = time.perf_counter()
        config = next(n for n, c in job.CONFIGS.items() if c == s["cfg"])
        write_job(jobdir, plan=plan, config=config, params_seed=0, infer_key=4,
                  session_seed=0, x=s["X"], pool=s["pools"]["reduced"])
        write_s = time.perf_counter() - t0
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   OMP_NUM_THREADS="1")
        framed = plan.schedule().framed()

        def launch(*extra_by_party):
            port = free_port()
            procs = []
            for p in (0, 1):
                link = (["--listen", f"127.0.0.1:{port}"] if p == 0
                        else ["--peer", f"127.0.0.1:{port}"])
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.party_host",
                     "--party", str(p), "--job", jobdir, "--device", "cuda",
                     "--timeout-s", str(DEPLOY_WAIT_S), *link, *extra_by_party[p]],
                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
            t0 = time.perf_counter()
            res = []
            try:
                for proc in procs:
                    out, err = proc.communicate(
                        timeout=max(1.0, DEPLOY_WAIT_S - (time.perf_counter() - t0)))
                    res.append((proc.returncode, out, err))
            finally:
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.communicate()
            return res, time.perf_counter() - t0

        def outputs():
            rows = []
            for p in (0, 1):
                with np.load(os.path.join(jobdir, f"out{p}.npz")) as z:
                    rows.append(ring.from_limbs(z["lo"], z["hi"], "cuda"))
            stats = []
            for p in (0, 1):
                with open(os.path.join(jobdir, f"stats{p}.json")) as f:
                    stats.append(json.load(f))
            return torch.cat(rows), stats

        def ok(res, what):
            for p, (rc, out, err) in enumerate(res):
                if rc != 0:
                    raise AssertionError(f"deploy (c) {what}: party {p} exited "
                                         f"{rc}\n{out[-2000:]}\n{err[-4000:]}")

        res, clean_s = launch((), ())
        ok(res, "clean run")
        got, stats = outputs()
        if not torch.equal(got, sim["reduced"]["out"].data):
            raise AssertionError("deploy (c): party processes' shares differ")
        for st in stats:
            if (st["rounds"], st["payload_bytes"]) != (framed.n_rounds, framed.bytes_tx):
                raise AssertionError(f"deploy (c): {st} != framed {framed.n_rounds} "
                                     f"/ {framed.bytes_tx}")
        journals = [os.path.join(tmp, f"j{p}") for p in (0, 1)]
        jargs = [["--journal", journals[p], "--snapshot-every",
                  str(DEPLOY_SNAPSHOT_EVERY)] for p in (0, 1)]
        res, kill_s = launch(jargs[0] + ["--die-after-round", str(DEPLOY_DIE_AFTER)],
                             jargs[1])
        if (res[0][0], res[1][0]) != (42, 17):
            raise AssertionError(f"deploy (c): kill run exited {res[0][0]} / "
                                 f"{res[1][0]}, want 42 / 17\n{res[1][2][-4000:]}")
        res, resume_s = launch(*jargs)
        ok(res, "journal resume")
        got, resumed = outputs()
        if not torch.equal(got, sim["reduced"]["out"].data):
            raise AssertionError("deploy (c): resumed shares differ")
        for st in resumed:
            if (st["resume_round"], st["replayed"], st["rounds"]) != \
                    (DEPLOY_DIE_AFTER, DEPLOY_DIE_AFTER,
                     framed.n_rounds - DEPLOY_DIE_AFTER):
                raise AssertionError(f"deploy (c) resume: {st}")
        writes = _journal_writes(plan.schedule().round_bytes, DEPLOY_DIE_AFTER,
                                 DEPLOY_SNAPSHOT_EVERY, framed.n_rounds)
        on_disk = [sum(os.path.getsize(os.path.join(d, f))
                       for d, _, fs in os.walk(j) for f in fs) for j in journals]
        rec = {"write_job_s": write_s, "clean_s": clean_s, "kill_s": kill_s,
               "resume_s": resume_s,
               "party_wall_s": [st["wall_s"] for st in stats],
               "resumed_party_wall_s": [st["wall_s"] for st in resumed],
               "journal_bytes_written": writes, "journal_bytes_on_disk": on_disk,
               "stats": stats, "resumed_stats": resumed}
        print(f"deploy (c) party_host processes, reduced: write_job {write_s:.2f} s; "
              f"clean run {clean_s:.1f} s (each party's call "
              f"{stats[0]['wall_s']:.3f} / {stats[1]['wall_s']:.3f} s), kill after "
              f"round {DEPLOY_DIE_AFTER}: exits 42 / 17 in {kill_s:.1f} s, relaunch "
              f"resumed at round {DEPLOY_DIE_AFTER} ({resumed[0]['replayed']} replayed) "
              f"in {resume_s:.1f} s; shares equal; journal payload written "
              f"{writes['party0']} / {writes['party1']} B (snapshot every "
              f"{DEPLOY_SNAPSHOT_EVERY} rounds), last snapshots on disk "
              f"{on_disk[0]} / {on_disk[1]} B", flush=True)
        return rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _deploy_link(s):
    """(d) A leader ``InferenceEngine`` with ``EngineLink`` and a
    ``serve_follower`` thread serve ``DEPLOY_LINK_REQUESTS`` (single
    images, two tenants, per-tenant ``StreamingTTP`` triples sliced per
    party); every request equal to the single-process SimComm engine's
    serial run (``max_batch=1``) of the same ids; both sides' framed bytes
    equal."""
    from repro_torch import api, serve
    from repro_torch.core.hummingbird import HBConfig, HBLayer
    from repro_torch.kernels import ops
    from repro_torch.models import resnet
    from repro_torch.transport import (EngineLink, free_port, serve_follower,
                                       tenant_provider_factory)

    cfg, params = s["cfg"], s["params"]
    exact = resnet.trace(params, cfg, batch=1)
    plan = exact.with_hb(HBConfig(
        tuple([HBLayer(k=21, m=13)] * (exact.n_groups - 1) + [HBLayer(k=13, m=13)]),
        exact.group_elements))
    afn = _deploy_afn(cfg)
    gen = torch.Generator().manual_seed(9)
    xs = [(torch.rand((1, 3, cfg.in_hw, cfg.in_hw), generator=gen) * 2 - 1).cuda()
          for _ in DEPLOY_LINK_REQUESTS]
    os.environ["HB_ROUND_LOOP"] = "python"
    port = free_port()

    def follower():
        session = api.Session.connect(
            1, peer=("127.0.0.1", port), key=0, session_id="deploy-link",
            plan_digest=plan.digest(), timeout_s=DEPLOY_WAIT_S,
            handshake_timeout_s=DEPLOY_WAIT_S, device="cuda")
        model = api.compile(afn, params, cfg, plan, session)
        try:
            return serve_follower(session.transport, model,
                                  provider_factory=tenant_provider_factory(
                                      DEPLOY_TTP_SEED, party=1, device="cuda")), \
                list(session.transport.round_bytes)
        finally:
            session.transport.close()

    def leader():
        session = api.Session.connect(
            0, listen=("127.0.0.1", port), key=0, session_id="deploy-link",
            plan_digest=plan.digest(), timeout_s=DEPLOY_WAIT_S,
            handshake_timeout_s=DEPLOY_WAIT_S, device="cuda")
        engine = serve.InferenceEngine(
            afn, params, cfg, plan, session,
            policy=serve.BatchPolicy(max_batch=DEPLOY_LINK_MAX_BATCH),
            provider_factory=tenant_provider_factory(DEPLOY_TTP_SEED, party=0,
                                                     device="cuda"))
        link = EngineLink(engine)
        try:
            futs = [engine.submit(t, x, request_id=i)
                    for (i, t), x in zip(DEPLOY_LINK_REQUESTS, xs)]
            engine.flush()
            outs = [f.result(timeout_s=DEPLOY_WAIT_S) for f in futs]
            return outs, list(engine.reports), list(session.transport.round_bytes)
        finally:
            link.shutdown()
            session.transport.close()

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    (outs, reports, lead_bytes), (served, follow_bytes) = _run_threads([leader, follower])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _deploy_counts()
    oracle = serve.InferenceEngine(
        afn, params, cfg, plan, api.Session(key=0, device="cuda"),
        policy=serve.BatchPolicy(max_batch=1),
        provider_factory=tenant_provider_factory(DEPLOY_TTP_SEED, device="cuda"))
    futs = [oracle.submit(t, x, request_id=i)
            for (i, t), x in zip(DEPLOY_LINK_REQUESTS, xs)]
    oracle.flush()
    want = [f.result(timeout_s=DEPLOY_WAIT_S) for f in futs]
    _same_shares("deploy (d) engine link", outs, want,
                 "a request differs from its SimComm serial oracle")
    if served != len(reports) or lead_bytes != follow_bytes:
        raise AssertionError(f"deploy (d): follower served {served} of "
                             f"{len(reports)} batches; wire bytes differ")
    for rep in reports:
        if (rep.measured_rounds, rep.measured_bytes) != \
                (rep.predicted_rounds, rep.predicted_bytes):
            raise AssertionError(f"deploy (d): batch {rep.request_ids} measured "
                                 f"{rep.measured_rounds} / {rep.measured_bytes}, "
                                 f"predicted {rep.predicted_rounds} / "
                                 f"{rep.predicted_bytes}")
    if {k for k in SHAPE_KERNELS if counts[k]} != PATH_KERNELS["reduced"]:
        raise AssertionError(f"deploy (d): launched {counts}")
    rec = {"batches": [list(r.request_ids) for r in reports],
           "batch_wall_s": [r.wall_s for r in reports],
           "rounds": [r.measured_rounds for r in reports], "wall_s": wall,
           "launches": counts}
    print(f"deploy (d) engine link: {len(DEPLOY_LINK_REQUESTS)} requests from 2 "
          f"tenants in batches {rec['batches']} ({rec['rounds']} rounds, "
          f"{', '.join(f'{w:.3f}' for w in rec['batch_wall_s'])} s), {wall:.1f} s "
          f"in all; every request equal to its SimComm serial oracle", flush=True)
    return rec


def deploy_phase():
    """Two parties, each holding only its own share rows, on the card: (a)
    faults in process, (b) two threads over localhost sockets, (c) two
    ``party_host`` processes and a journal resume, (d) the engine link.
    Returns the record and the path's launches per kernel (summed over
    (b)'s unshaped runs), the setup and the SimComm oracle's runs (the
    mesh phase's inputs)."""
    t0 = time.perf_counter()
    s = deploy_setup()
    setup_s = time.perf_counter() - t0
    sim = {name: _deploy_sim(name, s) for name in DEPLOY_PLANS}
    for name in DEPLOY_PLANS:
        print(f"deploy {name}: SimComm generator loop {sim[name]['wall']:.3f} s, "
              f"max reveal err {sim[name]['max_err']:.3g}", flush=True)
    stamps = {"setup_s": setup_s}
    t0 = time.perf_counter()
    faults_rec = _deploy_faults(s, sim)
    stamps["faults_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    threads_rec, launches = _deploy_threads(s, sim)
    stamps["threads_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    procs_rec = _deploy_processes(s, sim)
    stamps["processes_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    link_rec = _deploy_link(s)
    stamps["link_s"] = time.perf_counter() - t0
    print(f"deploy phase parts: {json.dumps(stamps)}", flush=True)
    return ({"offline_s": s["offline_s"], "faults": faults_rec,
             "threads": threads_rec, "processes": procs_rec, "link": link_rec,
             "parts_s": stamps}, launches, s, sim)


def party_kernel_rows(shapes: dict, path: str, rm_label: str = "one party") -> tuple:
    """Each ReLU kernel and ring_matmul at a local party dimension of 1, at
    ``shapes`` (kernel -> the shapes ``resnet_shape_launches`` keys it by),
    against its plain version: every shape checked, the largest word count
    timed (records on ``path``); the opening forms (beaver_and's,
    ks_combine's and ks_step's reads of the peer's halves with ``sel``) for
    party 0 (sel all-ones) and party 1 (sel zero).  Returns the timed
    records and the count of shapes checked."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(24)
    scratch = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    rows = []
    stem_words = max(n for _, n in shapes["ks_mask"])
    checked = 0

    def check(name, shape, fn, plain, bytes_moved, timed, ops_s=0.0):
        nonlocal checked
        if timed:
            timed_record(rows, scratch.zero_, name, SOURCES[name], REPLACES[name],
                         fn, plain, bytes_moved, ops_s=ops_s, shape=shape,
                         path=path)
        else:
            max_abs_err(fn(), plain())
        checked += 1

    P = 1
    for w, n_words in sorted(shapes["ks_mask"], reverse=True):
        timed = n_words == stem_words
        shifts = sorted(s for ww, nw, s in shapes["ks_step"] if (ww, nw) == (w, n_words))
        for party in (0, 1):
            sel = torch.tensor([-1 if party == 0 else 0], dtype=torch.int32,
                               device="cuda")
            tag = f"P=1 party {party} w={w} W={n_words}"
            t = timed and party == 0
            d, e, a, b, c = (words(gen, P, w, n_words) for _ in range(5))
            sent, recv = words(gen, P, 2, w, n_words), words(gen, P, 2, w, n_words)
            halves = (sent[:, 0], sent[:, 1], a, b, c, sel, recv[:, 0], recv[:, 1])
            check("beaver_and", f"{tag} opening", lambda: ops.beaver_and(*halves),
                  lambda: ref.beaver_and_open(*halves), (8 * d.numel() + P) * 4, t)
            g, p = words(gen, P, w, n_words), words(gen, P, w, n_words)
            a2, b2, c2 = (words(gen, P, 2 * w, n_words) for _ in range(3))
            if party == 0:
                check("ks_mask", f"{tag} shift=1", lambda: ops.ks_mask(g, p, a2, b2, 1),
                      lambda: torch.stack(ref.ks_mask(g, p, a2, b2, 1), dim=1),
                      40 * P * w * n_words, t)
            sent2 = words(gen, P, 2, 2 * w, n_words)
            opened = words(gen, P, 2, 2 * w, n_words)
            args = (sent2[:, 0], opened[:, 0], sent2[:, 1], opened[:, 1], a2, b2, c2,
                    sel, g)
            check("ks_combine", tag, lambda: ops.ks_combine(*args),
                  lambda: ref.ks_combine(*args), 68 * P * w * n_words + 4 * P, t)
            a3, b3 = words(gen, P, 2 * w, n_words), words(gen, P, 2 * w, n_words)
            for shift in shifts:
                g3, g4 = g.clone(), g.clone()
                check("ks_step", f"{tag} shift={shift}",
                      lambda: ops.ks_step(sent2, opened[:, 0], opened[:, 1], a2, b2,
                                          c2, sel, g3, a3, b3, shift),
                      lambda: ref.ks_step(sent2, opened[:, 0], opened[:, 1], a2, b2,
                                          c2, sel, g4, a3, b3, shift),
                      96 * P * w * n_words + 4 * P, t and shift == shifts[0])
    for k, m, e in sorted(shapes["pack_ring"], reverse=True):
        x = ring_values(gen, P, e)
        r = words(gen, P, k - m, (e + 31) // 32)
        check("pack_ring", f"P=1 E={e} k={k} m={m} masked",
              lambda: ops.pack_ring(x, k, m, mask=r), lambda: ref.pack_ring(x, k, m, r),
              8 * P * e + 8 * r.numel(), (e + 31) // 32 == stem_words)
    for n in sorted(shapes["unpack"], reverse=True):
        packed = words(gen, P, 1, (n + 31) // 32)
        check("unpack", f"R=1 w=1 W={packed.shape[-1]} n={n}",
              lambda: ops.unpack(packed, n), lambda: ref.unpack(packed, n),
              4 * packed.numel() + 4 * P * n, packed.shape[-1] == stem_words)
    stem_m = max((m for m, _, _ in shapes["ring_matmul"]), default=0)
    for m, k, n in sorted(shapes["ring_matmul"], reverse=True):
        x = torch.randint(-2 ** 63, 2 ** 63 - 1, (m, k), generator=gen,
                          dtype=torch.int64).cuda()
        wt = torch.randint(-2 ** 31, 2 ** 31, (k, n), generator=gen,
                           dtype=torch.int64).to(torch.int32).cuda()
        bytes_s, ops_s = ring_matmul_bound_s(m, k, n)
        check("ring_matmul", f"M={m} K={k} N={n} ({rm_label})",
              lambda: ops.ring_matmul(x, wt), lambda: ref.ring_matmul(x, wt),
              bytes_s * HBM_BYTES_PER_S, m == stem_m and k == 576, ops_s=ops_s)
    return rows, checked


def deploy_kernel_phase():
    """``party_kernel_rows`` at the deploy path's shapes
    (``resnet_shape_launches`` of its plans, one party: P = 1, batch 4)."""
    from repro_torch.configs import RESNET18
    from repro_torch.core.hummingbird import HBConfig, HBLayer
    from repro_torch.models import resnet

    params = resnet.init(RESNET18, seed=0, device="meta")
    exact = resnet.trace(params, RESNET18, batch=DEPLOY_BATCH)
    reduced = exact.with_hb(HBConfig(
        tuple([HBLayer(k=21, m=13)] * (exact.n_groups - 1) + [HBLayer(k=13, m=13)]),
        exact.group_elements))
    shapes = {k: set() for k in SHAPE_KERNELS}
    for plan in (exact, reduced):
        for k, by_shape in resnet_shape_launches(plan, streams=1, batch=2).items():
            shapes[k] |= set(by_shape)
    rows, checked = party_kernel_rows(shapes, "deploy")
    print(f"deploy kernels: {checked} P = 1 launches at the deploy path's shapes "
          f"equal their plain versions, {len(rows)} timed", flush=True)
    return rows


# the examples phase: the port's twins of the reference's five user
# scripts (``tools/``), each at its defaults on the card, the first four in
# this process through ``main(argv)``, two_party_serving as its own process
# tree on a job directory written here; the first three and
# two_party_serving again on the host's CPU, whose results must equal the
# card's bit for bit; each process tree bounded by EXAMPLES_WAIT_S
EXAMPLES = ("quickstart", "api_smoke", "serving_engine", "private_inference")
EXAMPLES_ON_CPU = ("quickstart", "api_smoke", "serving_engine")
EXAMPLES_WAIT_S = 600.0
# the compiled calls each in-process twin makes (api_smoke: ``__call__``
# and ``serve_step``), each its signature's first on the captured replay
# (``HB_ROUND_LOOP=scan``, the users' default, set for the phase): the
# generator loop, then the capture, so each launch is counted twice
EXAMPLES_CAPTURES = {"quickstart": 0, "api_smoke": 2, "serving_engine": 1,
                     "private_inference": 1}


def _tool(name: str):
    """``tools/<name>.py`` of this checkout as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_tree(cmd, timeout_s: float):
    """Run ``cmd`` in a session of its own; at the deadline its whole
    process group (the command and every process it started) is killed."""
    import signal

    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=ROOT, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"{cmd} not done in {timeout_s:.0f} s: {err[-3000:]}")
    return proc.returncode, out, err


def _plan_launches(plan, parties: int = 2, calls: int = 1, out: dict = None) -> dict:
    """``resnet_shape_launches`` of ``calls`` one-stream RESNET_SMOKE calls
    of ``plan`` at its traced input, ``parties`` rows an image."""
    from repro_torch.configs import RESNET_SMOKE

    b, _, hw, _ = plan.input_shape
    matmuls = resnet_matmul_shapes(RESNET_SMOKE, hw, parties * b)
    for _ in range(calls):
        out = resnet_shape_launches(plan, streams=1, out=out, matmuls=matmuls)
    return out


def examples_shape_launches(record: dict, job_plan) -> dict:
    """Each twin's launches by kernel and shape, read from the plans it ran:
    quickstart's two ReLUs of its values at (64, 0) and its (k, m), on no
    round loop; api_smoke's plan twice (``__call__`` and ``serve_step``),
    serving_engine's three requests (each its own stream and plan) and
    private_inference's one call over its requests, each compiled call
    twice (``EXAMPLES_CAPTURES``); two_party_serving's leader, one party
    (P = 1) on a socket link (the generator loop), once a request."""
    from repro_torch import api
    from repro_torch.core.hummingbird import HBLayer

    q = record["quickstart"]["out"]
    serving = None
    for p in record["serving_engine"]["out"]["plans"]:
        serving = _plan_launches(api.Plan.from_json(p), out=serving,
                                 calls=2 * EXAMPLES_CAPTURES["serving_engine"])
    return {"quickstart": relu_shape_launches(
                [(len(q["x"]), HBLayer(64, 0)), (len(q["x"]), HBLayer(q["k"], q["m"]))]),
            "api_smoke": _plan_launches(
                api.Plan.from_json(record["api_smoke"]["out"]["plan"]),
                calls=2 * EXAMPLES_CAPTURES["api_smoke"]),
            "serving_engine": serving,
            "private_inference": _plan_launches(
                api.Plan.from_json(record["private_inference"]["out"]["plan"]),
                calls=2 * EXAMPLES_CAPTURES["private_inference"]),
            "two_party_serving": _plan_launches(
                job_plan, parties=1,
                calls=len(record["two_party_serving"]["out"]["requests"]))}


def examples_kernel_phase(shapes: dict) -> list:
    """Each kernel against its plain version at every shape the examples
    path launches it at (``examples_shape_launches``): the in-process
    twins' ReLU kernels at P = 2 (``search_kernel_phase``),
    two_party_serving's at P = 1 in both parties' opening forms, and
    ring_matmul at every twin's shapes (``party_kernel_rows``)."""
    def union(names):
        return {k: set().union(*(shapes[n][k] for n in names)) for k in SHAPE_KERNELS}

    both, one = union(EXAMPLES), union(("two_party_serving",))
    rows = search_kernel_phase(both, path="examples")
    one["ring_matmul"] |= both["ring_matmul"]
    p1_rows, checked = party_kernel_rows(one, "examples", rm_label="examples")
    print(f"examples kernels: every P = 2 ReLU kernel shape ({len(rows)} timed) and "
          f"{checked} P = 1 and ring_matmul shapes equal their plain versions",
          flush=True)
    return rows + p1_rows


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _two_party(job: str, device: str, out_dir: str) -> tuple:
    """two_party_serving on the job directory ``job`` with ``--device``:
    (wall s, its returned JSON); a non-zero exit raises."""
    t0 = time.perf_counter()
    rc, out, err = _run_tree([sys.executable, os.path.join(ROOT, "tools",
                                                           "two_party_serving.py"),
                              "--job", job, "--device", device], EXAMPLES_WAIT_S)
    wall = time.perf_counter() - t0
    tag = "" if device == "cuda" else f"_{device}"
    with open(os.path.join(out_dir, f"two_party_serving{tag}.txt"), "w") as f:
        f.write(out + "\n--- stderr ---\n" + err)
    if rc != 0:
        raise AssertionError(f"examples: two_party_serving --device {device} "
                             f"exited {rc}: {err[-3000:]}")
    return wall, out


def examples_phase():
    """The five twins of ``examples/`` on the card (``tools/quickstart.py``,
    ``api_smoke.py``, ``serving_engine.py``, ``private_inference.py``,
    ``two_party_serving.py``), each at its defaults (two_party_serving on a
    job its ``make_job`` writes here on the card, as its default run does;
    the round loop the users' default, the captured replay).  The launch
    counters are zeroed just before each in-process twin and read just
    after; two_party_serving's are its leader process's, from its
    ``/stats``.  Requires: every twin finishes on the card, each compiled
    call capturing its replay (``EXAMPLES_CAPTURES``); each twin's
    launches equal, kernel by kernel, what the plans it ran price
    (``examples_shape_launches``; every ReLU's pack_ring masked);
    quickstart's exact ReLU within 1e-3 of max(x, 0); every served
    batch's measured rounds (and serving_engine's bytes) equal the
    predicted ones, the transport's rounds the batches' sum; quickstart,
    api_smoke, serving_engine and two_party_serving return the same on the
    host's CPU (shares, reveals, logits, rounds, usage, Gantt chart), bit
    for bit; each kernel equals its plain version at every shape the twins
    launch it at (``examples_kernel_phase``).  Returns (record, launches,
    kernel rows)."""
    import tempfile

    from repro_torch import api
    from repro_torch.api.compile import replay_cache_stats
    from repro_torch.kernels import ops

    record, launches = {}, {}
    loop_mode = os.environ.get("HB_ROUND_LOOP")
    os.environ["HB_ROUND_LOOP"] = "scan"
    out_dir = os.path.join(ROOT, "chiprun_out", "examples")
    os.makedirs(out_dir, exist_ok=True)

    def run(mod, name, argv):
        """``mod.main(argv)``, its output kept in ``out_dir`` and printed but
        for its last (JSON) line; all of it printed when the twin fails."""
        buf, ok = io.StringIO(), False
        try:
            with contextlib.redirect_stdout(buf):
                res = mod.main(argv)
            ok = True
        finally:
            text = buf.getvalue()
            with open(os.path.join(out_dir, f"{name}{'_cpu' if argv else ''}.txt"),
                      "w") as f:
                f.write(text)
            if not argv or not ok:
                print("\n".join(text.rstrip().splitlines()[:-1] if ok else [text]),
                      flush=True)
        return res

    for name in EXAMPLES:
        mod = _tool(name)
        torch.cuda.synchronize()
        ops.reset_launches()
        cache0 = len(replay_cache_stats())
        t0 = time.perf_counter()
        out = run(mod, name, [])
        torch.cuda.synchronize()
        record[name] = {"wall_s": time.perf_counter() - t0, "out": out,
                        "launches": _deploy_counts(),
                        "captures": len(replay_cache_stats()) - cache0}
        if (out["device"], record[name]["captures"]) != ("cuda", EXAMPLES_CAPTURES[name]):
            raise AssertionError(f"examples: {name} ran on {out['device']} and "
                                 f"captured {record[name]['captures']} replays, "
                                 f"expected {EXAMPLES_CAPTURES[name]}")
        if name in EXAMPLES_ON_CPU:
            t0 = time.perf_counter()
            cpu = run(mod, name, ["--device", "cpu"])
            record[name]["cpu_wall_s"] = time.perf_counter() - t0
            differ = sorted(k for k in out if k != "device" and out[k] != cpu.get(k))
            if differ:
                raise AssertionError(f"examples: {name} on the card and on the CPU "
                                     f"differ in {differ}")
        print(f"examples: {name} on the card in {record[name]['wall_s']:.2f} s"
              + (f", on the CPU in {record[name]['cpu_wall_s']:.2f} s (equal)"
                 if name in EXAMPLES_ON_CPU else "")
              + f"; launches {_nonzero(record[name]['launches'])}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "job")
        with contextlib.redirect_stdout(io.StringIO()):
            _tool("two_party_serving").make_job(job, "cuda")
        job_plan = api.Plan.load(os.path.join(job, "plan.json"))
        wall, out = _two_party(job, "cuda", out_dir)
        print("\n".join(out.rstrip().splitlines()[:-1]), flush=True)
        card = json.loads(out.strip().splitlines()[-1])
        cpu_wall, cpu_out = _two_party(job, "cpu", out_dir)
        cpu = json.loads(cpu_out.strip().splitlines()[-1])
    record["two_party_serving"] = {"wall_s": wall, "cpu_wall_s": cpu_wall, "out": card,
                                   "launches": card["leader_launches"]}
    same = ("tenant", "argmax", "y", "measured_rounds", "predicted_rounds")
    if [{k: r[k] for k in same} for r in card["requests"]] != \
            [{k: r[k] for k in same} for r in cpu["requests"]]:
        raise AssertionError("examples: two_party_serving's replies on the card and "
                             "on the CPU differ")
    print(f"examples: two_party_serving (three processes) on the card in {wall:.2f} s, "
          f"on the CPU in {cpu_wall:.2f} s (replies equal); leader launches "
          f"{_nonzero(card['leader_launches'])}", flush=True)

    q = record["quickstart"]["out"]
    err = max(abs(a - max(x, 0.0)) for a, x in zip(q["exact"], q["x"]))
    if err > 1e-3:
        raise AssertionError(f"examples: quickstart's exact ReLU off by {err}")
    s = record["serving_engine"]["out"]
    if (s["measured_rounds"], s["measured_bytes"]) != (s["predicted_rounds"],
                                                       s["predicted_bytes"]):
        raise AssertionError(f"examples: serving_engine's batch {s}")
    served = [(r["measured_rounds"], r["predicted_rounds"]) for r in card["requests"]]
    if any(m != p for m, p in served) or card["transport"]["retries"] or \
            card["transport"]["rounds"] != card["batches"] * served[0][1]:
        raise AssertionError(f"examples: two_party_serving served {served}, "
                             f"transport {card['transport']}")

    shapes = examples_shape_launches(record, job_plan)
    for name, by_shape in shapes.items():
        want = {k: sum(v.values()) for k, v in by_shape.items() if v}
        want["pack_ring_masked"] = want["pack_ring"]
        got = _nonzero(record[name]["launches"])
        if got != want:
            raise AssertionError(f"examples: {name} launched {got}, its plans "
                                 f"price {want}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    if loop_mode is None:
        os.environ.pop("HB_ROUND_LOOP")
    else:
        os.environ["HB_ROUND_LOOP"] = loop_mode
    return record, launches, examples_kernel_phase(shapes)


# the mesh phase (two-party device execution over ``launch.mesh``) runs the
# deploy phase's setup (full-width ResNet-18, one input of DEPLOY_BATCH
# images, its exact and reduced plans, one call's pool each, key 4): on the
# smoke mesh in this process, on a (2, 1) mesh of two spawned gloo ranks
# and on a (2, MESH_DATA) mesh of 2 * MESH_DATA (reduced only); every
# spawned run bounded by MESH_WAIT_S; the data axis's reveal within the
# reference's tolerance (``tests/test_engine.py``'s data-axis script)
MESH_DATA = 2
MESH_WAIT_S = 300.0
# timed jit_step calls a plan on every rank, after one untimed call of
# every plan (median, min and max printed)
MESH_CALLS = 3
MESH_REVEAL_ATOL = 2 ** (13 - 16) + 1e-4


def mesh_rank(rank, world, init_method, plans, names, x_data, nccl_probe=False):
    """One rank of a mesh of the mesh phase, in its own spawned process on
    the one card (``launch.mesh.spawn_local``): its (2, world / 2) gloo
    mesh; the deploy setup's weights (``resnet.init(cfg, seed=0)``) and
    each plan's pool (key 3; ``shard_pool`` on a data axis) made here; one
    untimed ``jit_step`` call of every plan (the process's first loads, the
    allocator's and gloo's buffers grown), then each plan ``MESH_CALLS``
    times, each call timed from a barrier, with the launch counters zeroed
    just before and read just after; every call's block, census and
    launches must equal the first's.  Returns per plan its walls, census,
    output block, launches and (rank 0) the gathered output, on the CPU;
    with ``nccl_probe``, the gloo group left, then ``mesh_nccl_probe``'s
    record."""
    import torch.distributed as dist

    from repro_torch import api
    from repro_torch.configs import RESNET18
    from repro_torch.core import beaver, prng
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mpc_mesh
    from repro_torch.models import resnet

    torch.cuda.set_device(0)
    n_data = world // 2
    mesh = make_mpc_mesh(n_data, backend="gloo", device="cuda",
                         init_method=init_method, rank=rank)
    data_axis = "data" if n_data > 1 else None
    params = resnet.init(RESNET18, seed=0, device="cuda")
    x, key = x_data.cuda(), prng.PRNGKey(4, "cuda")
    steps = {}
    for name in names:
        pool = beaver.gen_plan_triples(prng.PRNGKey(3, "cuda"), plans[name].triple_specs())
        if data_axis is not None:
            pool = beaver.shard_pool(pool, n_data)
        model = api.compile(_deploy_afn(RESNET18), params, RESNET18, plans[name],
                            api.Session(key=0, device="cuda"))
        steps[name] = (model.jit_step(mesh, data_axis=data_axis), pool)
    for step, pool in steps.values():
        step(params, x, pool, key)
    runs = {}
    for name in names:
        step, pool = steps[name]
        walls, first = [], None
        for i in range(MESH_CALLS):
            torch.cuda.synchronize()
            dist.barrier()
            ops.reset_launches()
            t0 = time.perf_counter()
            block = step(params, x, pool, key)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            got = (block, _deploy_counts(), [(c.count, c.bytes) for c in step.census])
            if first is None:
                first = got
            elif not torch.equal(got[0], first[0]) or got[1:] != first[1:]:
                raise AssertionError(f"mesh rank {rank} {name}: call {i}'s block, "
                                     "launches or census differ from the first's")
        gathered = mesh.gather(block, step.spec)
        runs[name] = {"wall_s": walls, "block": block.cpu(), "launches": first[1],
                      "census": first[2],
                      "gathered": None if gathered is None else gathered.cpu()}
    out = {"coords": dict(mesh.coords), "runs": runs}
    if nccl_probe:
        dist.barrier()
        dist.destroy_process_group()
        out["nccl_probe"] = mesh_nccl_probe(rank, world, init_method + "_nccl")
    return out


def mesh_nccl_probe(rank, world, init_method):
    """Two ranks on the one card asking for an NCCL mesh: ``make_mpc_mesh``
    must refuse them (its message returned); then one NCCL all-reduce on
    the group they made, whose error (or result) is returned too."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mpc_mesh

    out = {"check": None}
    try:
        make_mpc_mesh(world // 2, backend="nccl", device="cuda",
                      init_method=init_method, rank=rank)
    except ValueError as e:
        out["check"] = str(e)
    try:
        t = torch.ones(1, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        out["nccl"] = f"no error: the all-reduce gave {t.item()}"
    except Exception as e:         # noqa: BLE001 (NCCL's refusal is the record)
        out["nccl"] = f"{type(e).__name__}: {e}"
    if dist.is_initialized():
        dist.destroy_process_group()
    return out


def _mesh_smoke(s, sim):
    """(a) The smoke mesh in this process: per plan, ``serve_step(None)``
    on the captured replay (its first call captures), then ``jit_step`` on
    ``make_mpc_smoke_mesh()`` and with ``data_axis="data"`` on
    ``shard_pool(pool, 1)``, each once on the replay (timed beside
    ``serve_step(None)``'s: its counters the schedule round for round, its
    census empty, the flips being in the graph) and once on the generator
    loop (its census the schedule round for round: one exchange handed to
    the ``MeshComm`` per fused round); every call's shares equal to the
    SimComm oracle's."""
    from repro_torch import api
    from repro_torch.core import beaver, prng
    from repro_torch.launch.mesh import make_mpc_smoke_mesh

    os.environ["HB_ROUND_LOOP"] = "scan"
    mesh, key, X = make_mpc_smoke_mesh("cuda"), prng.PRNGKey(4, "cuda"), s["X"]
    rec = {}
    for name in DEPLOY_PLANS:
        plan, pool = s["plans"][name], s["pools"][name]
        sched = plan.schedule()
        model = api.compile(_deploy_afn(s["cfg"]), s["params"], s["cfg"], plan,
                            api.Session(key=0, device="cuda"))
        replay = model.serve_step()
        first, first_s = _timed(lambda: replay(s["params"], X.data, pool, key))
        want, replay_s = _timed(lambda: replay(s["params"], X.data, pool, key))
        r = {"first_call_s": first_s, "replay_s": replay_s}
        for data_axis, triples in ((None, pool), ("data", beaver.shard_pool(pool, 1))):
            step = model.jit_step(mesh, data_axis=data_axis)
            where = f"mesh (a) {name} data_axis={data_axis}"
            got, wall = _timed(lambda: step(s["params"], X.data, triples, key))
            if (step.comm.n_rounds, step.comm.round_bytes) != \
                    (sched.n_rounds, list(sched.round_bytes)) or step.census:
                raise AssertionError(f"{where}: the replay counted {step.comm.n_rounds} "
                                     f"rounds / {step.comm.bytes_tx} B and "
                                     f"{len(step.census)} host exchanges; the schedule "
                                     f"says {sched.n_rounds} / {sched.bytes_tx} and "
                                     "the graph holds the flips")
            os.environ["HB_ROUND_LOOP"] = "python"
            eager, eager_s = _timed(lambda: step(s["params"], X.data, triples, key))
            os.environ["HB_ROUND_LOOP"] = "scan"
            census = [(c.count, c.bytes) for c in step.census]
            if census != [(1, b) for b in sched.round_bytes]:
                raise AssertionError(f"{where}: on the generator loop, census "
                                     f"{len(census)} exchanges / "
                                     f"{sum(b for _, b in census)} B != schedule "
                                     f"{sched.n_rounds} / {sched.bytes_tx}")
            for what, out in (("first", first), ("replay", want), ("mesh", got),
                              ("mesh generator-loop", eager)):
                if not torch.equal(out, sim[name]["out"].data):
                    raise AssertionError(f"{where}: the {what} call's shares differ "
                                         "from SimComm's")
            r["data" if data_axis else "party"] = {"wall_s": wall, "eager_wall_s": eager_s,
                                                   "rounds": len(census),
                                                   "bytes": sum(b for _, b in census)}
        rec[name] = r
        print(f"mesh (a) smoke mesh {name}: jit_step on the replay "
              f"{r['party']['wall_s']:.4f} s, with the data axis "
              f"{r['data']['wall_s']:.4f} s, beside serve_step(None)'s replay "
              f"{replay_s:.4f} s (its first call, with the capture, {first_s:.3f} s); "
              f"on the generator loop {r['party']['eager_wall_s']:.4f} / "
              f"{r['data']['eager_wall_s']:.4f} s; shares equal SimComm's; replayed "
              f"counters and the generator loop's census {sched.n_rounds} exchanges / "
              f"{sched.bytes_tx} B == the schedule", flush=True)
    os.environ.pop("HB_ROUND_LOOP", None)
    return rec


def _mesh_ranks_check(what, name, res, sched, want_blocks, launches_want):
    """Every rank's census equal to ``sched`` round for round, its block to
    ``want_blocks[coords]``; rank 0's launches to ``launches_want`` (the
    plan's kernels, every pack_ring masked)."""
    for r in res:
        run, at = r["runs"][name], (r["coords"]["party"], r["coords"]["data"])
        if run["census"] != [(1, b) for b in sched.round_bytes]:
            raise AssertionError(f"mesh {what} {name} rank at {at}: census "
                                 f"{len(run['census'])} exchanges / "
                                 f"{sum(b for _, b in run['census'])} B != schedule "
                                 f"{sched.n_rounds} / {sched.bytes_tx}")
        if not torch.equal(run["block"], want_blocks[at]):
            raise AssertionError(f"mesh {what} {name} rank at {at}: shares differ "
                                 "from the SimComm call's")
    counts = res[0]["runs"][name]["launches"]
    if {k: counts[k] for k in launches_want} != launches_want or \
            {k for k in launches_want if counts[k]} != PATH_KERNELS[name] or \
            counts["pack_ring_masked"] != counts["pack_ring"]:
        raise AssertionError(f"mesh {what} {name}: rank 0 launched {counts}, the "
                             f"plan says {launches_want}")
    return counts


def mesh_phase(s, sim, socket):
    """Two-party device execution on the one card: (a) the smoke mesh, (b)
    the party axis of size 2 as two spawned gloo ranks (each party's wall
    beside the deploy phase's socket parties', ``socket``: its (b)
    record), (c) the (2, 2) data-axis mesh as four, (d) (b)'s two ranks,
    their gloo group left, asking for NCCL on the one card.  Returns the
    record and rank 0's launches per kernel over (b) and (c)."""
    from repro_torch import api
    from repro_torch.core import beaver, fixed, prng
    from repro_torch.launch.mesh import spawn_local
    from repro_torch.models import resnet

    script = os.path.abspath(__file__)
    x_cpu = s["X"].data.cpu()
    stamps, t0 = {}, time.perf_counter()
    rec = {"smoke": _mesh_smoke(s, sim)}
    stamps["smoke_s"] = time.perf_counter() - t0
    total = {k: 0 for k in SHAPE_KERNELS}

    t0 = time.perf_counter()
    two = spawn_local(script, "mesh_rank", 2,
                      args=(s["plans"], DEPLOY_PLANS, x_cpu, True), timeout_s=MESH_WAIT_S)
    stamps["two_ranks_s"] = time.perf_counter() - t0
    rec["two_ranks"] = {}
    for name in DEPLOY_PLANS:
        want = sim[name]["out"].data.cpu()
        sched = s["plans"][name].schedule()
        counts = _mesh_ranks_check("(b)", name, two, sched,
                                   {(p, 0): want[p:p + 1] for p in (0, 1)},
                                   deploy_party_launches(s["plans"][name]))
        if not torch.equal(two[0]["runs"][name]["gathered"], want):
            raise AssertionError(f"mesh (b) {name}: the gathered shares differ from "
                                 "the SimComm call's")
        for k in SHAPE_KERNELS:
            total[k] += counts.get(k, 0)
        walls = [r["runs"][name]["wall_s"] for r in two]
        med = [statistics.median(w) for w in walls]
        sock = socket[name]["party_wall_s"]
        rec["two_ranks"][name] = {"party_wall_s": walls, "party_median_s": med,
                                  "rounds": sched.n_rounds,
                                  "bytes_per_party": sched.bytes_tx,
                                  "launches_rank0": counts,
                                  "sim_wall_s": sim[name]["wall"],
                                  "socket_party_wall_s": sock}
        print(f"mesh (b) {name}: two gloo ranks on the card, median "
              f"{med[0]:.4f} / {med[1]:.4f} s a party over {MESH_CALLS} warm calls "
              f"(party 0 min {min(walls[0]):.4f}, max {max(walls[0]):.4f}; party 1 "
              f"min {min(walls[1]):.4f}, max {max(walls[1]):.4f}) for "
              f"{sched.n_rounds} exchanges / {sched.bytes_tx} B a party staged "
              f"through pinned host memory ({sched.bytes_tx / 1e6 / max(med):.1f} "
              f"MB/s a direction at the slower median), beside the deploy phase's "
              f"socket parties' {sock[0]:.3f} / {sock[1]:.3f} s and SimComm's "
              f"{sim[name]['wall']:.3f} s; census == the schedule on both ranks; "
              f"gathered shares equal SimComm's; rank 0's launches as the plan "
              f"says", flush=True)

    t0 = time.perf_counter()
    name, plan = "reduced", s["plans"]["reduced"]
    per = DEPLOY_BATCH // MESH_DATA
    plan_shard = resnet.trace(resnet.init(s["cfg"], seed=0, device="meta"), s["cfg"],
                              batch=per, hb=plan.hb)
    shard_sched, full_sched = plan_shard.schedule(), plan.schedule()
    if shard_sched.n_rounds != full_sched.n_rounds or \
            MESH_DATA * shard_sched.bytes_tx != full_sched.bytes_tx:
        raise AssertionError(f"mesh (c): a shard's schedule {shard_sched.n_rounds} / "
                             f"{shard_sched.bytes_tx} against {full_sched.n_rounds} / "
                             f"{full_sched.bytes_tx} unsharded")
    four = spawn_local(script, "mesh_rank", 2 * MESH_DATA,
                       args=(s["plans"], (name,), x_cpu), timeout_s=MESH_WAIT_S)
    stamps["data_ranks_s"] = time.perf_counter() - t0
    os.environ["HB_ROUND_LOOP"] = "python"
    shard_want = {}
    for d in range(MESH_DATA):
        model = api.compile(_deploy_afn(s["cfg"]), s["params"], s["cfg"], plan,
                            api.Session(key=0, device="cuda", provider=beaver.TriplePool(
                                s["pools"][name]).shard(d, MESH_DATA)))
        out = model.serve_step()(s["params"], s["X"].data[:, d * per:(d + 1) * per],
                                 None, prng.PRNGKey(4, "cuda")).cpu()
        shard_want.update({(p, d): out[p:p + 1] for p in (0, 1)})
    os.environ.pop("HB_ROUND_LOOP", None)
    launches_want = {k: sum(v.values()) for k, v in
                     resnet_shape_launches(plan_shard, streams=1, batch=1).items()}
    counts = _mesh_ranks_check("(c)", name, four, shard_sched, shard_want, launches_want)
    for k in SHAPE_KERNELS:
        total[k] += counts.get(k, 0)
    gathered = four[0]["runs"][name]["gathered"]
    full = sim[name]["out"].data.cpu()
    err = float((fixed.decode(gathered[0] + gathered[1])
                 - fixed.decode(full[0] + full[1])).abs().max())
    if gathered.shape != full.shape or not err <= MESH_REVEAL_ATOL:
        raise AssertionError(f"mesh (c): the sharded reveal differs from the "
                             f"unsharded call's by {err} (limit {MESH_REVEAL_ATOL})")
    walls = [statistics.median(r["runs"][name]["wall_s"]) for r in four]
    rec["data_ranks"] = {"shape": (2, MESH_DATA), "party_wall_s":
                         [r["runs"][name]["wall_s"] for r in four],
                         "party_median_s": walls,
                         "rounds": shard_sched.n_rounds,
                         "bytes_per_shard_party": shard_sched.bytes_tx,
                         "reveal_max_diff": err, "launches_rank0": counts}
    print(f"mesh (c) {name}: a (2, {MESH_DATA}) mesh of {2 * MESH_DATA} gloo ranks, "
          f"median walls {', '.join(f'{w:.4f}' for w in walls)} s over "
          f"{MESH_CALLS} warm calls; every shard's census "
          f"{shard_sched.n_rounds} exchanges / {shard_sched.bytes_tx} B == the "
          f"schedule at batch {per} (unsharded {full_sched.bytes_tx} B); shares equal "
          f"the SimComm step on each shard's rows with TriplePool.shard; reveal "
          f"within {err:.3g} of the unsharded call's (limit {MESH_REVEAL_ATOL:.4g})",
          flush=True)

    probe = [r["nccl_probe"] for r in two]
    if not all(p["check"] for p in probe):
        raise AssertionError(f"mesh (d): make_mpc_mesh(backend='nccl') took two ranks "
                             f"on one card: {probe}")
    rec["nccl_probe"] = probe
    print(f"mesh (d) two NCCL ranks on one card: make_mpc_mesh raised "
          f"{probe[0]['check']!r}; NCCL itself: {probe[0]['nccl'][:400]!r}", flush=True)
    rec["parts_s"] = stamps
    print(f"mesh phase parts: {json.dumps(stamps)}", flush=True)
    return rec, total


def mesh_kernel_phase():
    """The mesh path's kernel shapes that no earlier phase holds, against
    their plain versions (``party_kernel_rows``, records on path "mesh"):
    the ReLU kernels at a data shard's P = 1 shapes (the reduced plan at
    batch DEPLOY_BATCH / MESH_DATA: the stem at W = 4096 words), and
    ring_matmul at the smoke mesh's P = 2 rows of DEPLOY_BATCH images."""
    from repro_torch.configs import RESNET18
    from repro_torch.core.hummingbird import HBConfig, HBLayer
    from repro_torch.models import resnet

    params = resnet.init(RESNET18, seed=0, device="meta")
    shard = resnet.trace(params, RESNET18, batch=DEPLOY_BATCH // MESH_DATA)
    shard = shard.with_hb(HBConfig(
        tuple([HBLayer(k=21, m=13)] * (shard.n_groups - 1) + [HBLayer(k=13, m=13)]),
        shard.group_elements))
    shapes = {k: set(v) for k, v in
              resnet_shape_launches(shard, streams=1, batch=1).items()}
    shapes["ring_matmul"] = set(resnet_shape_launches(
        shard, streams=1, batch=DEPLOY_BATCH)["ring_matmul"])
    rows, checked = party_kernel_rows(shapes, "mesh", rm_label=f"P = 2, batch "
                                                           f"{DEPLOY_BATCH}")
    print(f"mesh kernels: {checked} launches at the mesh path's new shapes equal "
          f"their plain versions, {len(rows)} timed", flush=True)
    return rows


ANALYSIS_SCHEDULE = {"exact": (170, 552599552), "reduced": (91, 98566144)}
ANALYSIS_FRESH_SEED = 40


def analysis_phase(s):
    """The protocol-safety gate on the card (phase 17): lint and lock
    checks over the port's files, then the leakage census of each deploy
    plan's ``serve_step`` on the deploy setup ``s``."""
    from repro_torch import api
    from repro_torch.analysis import census as census_lib, hbcheck, lint, locks
    from repro_torch.core import beaver, prng
    from repro_torch.core.mpc_tensor import MPCTensor
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    paths = hbcheck.default_paths(ROOT)
    findings = lint.lint_paths(paths, root=ROOT) + locks.check_paths(ROOT)
    baseline = lint.load_baseline(os.path.join(ROOT, hbcheck.DEFAULT_BASELINE))
    new = [f for f in findings if f.key() not in baseline]
    lint_s = time.perf_counter() - t0
    print(f"analysis: lint + locks over {len(paths)} paths: "
          f"{len(findings)} finding(s), {len(new)} not baselined ({lint_s:.2f} s)",
          flush=True)
    if new:
        raise AssertionError("hbcheck findings:\n" + "\n".join(map(str, new)))
    cfg = s["cfg"]
    gen = torch.Generator().manual_seed(ANALYSIS_FRESH_SEED)
    x_fresh = MPCTensor.from_plain(
        prng.PRNGKey(ANALYSIS_FRESH_SEED, "cuda"),
        (torch.rand(tuple(s["X"].shape), generator=gen) * 2 - 1).cuda()).data
    record = {"lint_findings": len(findings), "lint_s": lint_s, "census": {}}
    for name in DEPLOY_PLANS:
        plan = s["plans"][name]
        model = api.compile(_deploy_afn(cfg), s["params"], cfg, plan,
                            api.Session(key=0, device="cuda"))
        pools_s = []

        def masks(i, plan=plan, pools_s=pools_s):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pool = beaver.gen_plan_triples(
                prng.PRNGKey(ANALYSIS_FRESH_SEED + 10 * i, "cuda"), plan.triple_specs())
            torch.cuda.synchronize()
            pools_s.append(time.perf_counter() - t)
            return pool, prng.PRNGKey(ANALYSIS_FRESH_SEED + 10 * i + 1, "cuda")

        torch.cuda.synchronize()
        before = ops.launch_counts()
        t0 = time.perf_counter()
        summ = census_lib.serve_step_census(model, s["X"].data, s["pools"][name],
                                            prng.PRNGKey(4, "cuda"), x_fresh, masks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rounds = summ.pop("rounds")
        launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
        print(f"analysis census {name}: {summ['collectives']} rounds "
              f"({summ['masked_collectives']} masked, {summ['public_collectives']} "
              f"public, {summ['unmasked_collectives']} unmasked), {summ['bytes']} B a "
              f"party; schedule {summ['sched_rounds']} / {summ['sched_bytes']} B; "
              f"{len(rounds)} x {sum(r.elements for r in rounds)} elements classed "
              f"in {wall:.2f} s (fresh pools {[round(t, 3) for t in pools_s]} s)",
              flush=True)
        # cross_check_ok also holds that some element moved with the input;
        # round 0 is the first ReLU's A2B masks, so the input moves from 1
        if summ["unmasked_collectives"] or not summ["cross_check_ok"] or \
                summ["first_secret_round"] != 1 or \
                (summ["collectives"], summ["bytes"]) != ANALYSIS_SCHEDULE[name]:
            raise AssertionError(f"analysis census {name}: {summ}, want zero "
                                 f"unmasked, the input moving from round 1, "
                                 f"and {ANALYSIS_SCHEDULE[name]}")
        record["census"][name] = dict(
            summ, wall_s=wall, fresh_pool_s=pools_s, launches=launches,
            elements=sum(r.elements for r in rounds),
            masked_elements=sum(r.masked for r in rounds))
        del rounds
        torch.cuda.empty_cache()
    return record


# ---------------------------------------------------------------------------
# zoo: the plaintext model zoo's serving path (no kernel of the port's own)
# ---------------------------------------------------------------------------

ZOO_ARCH = "qwen1.5-0.5b"
ZOO_SERVE = (4, 128, 32)        # (a): requests, prompt tokens, greedy tokens
ZOO_F32 = (1, 32, 8)            # (b): the float32 run, on the card and on the CPU
# (b): card vs CPU, float32 logits (atol, rtol): the decode steps read each
# side's own bfloat16 cache, whose K/V can round one ulp apart (4.9e-4 seen)
ZOO_F32_TOL = (2e-3, 2e-3)
# decode vs apply in a float32 model: tests/test_archs_smoke.py's tolerance,
# which covers the bfloat16 cache; a bfloat16 model rounds every op and
# differs more (0.03-0.11 seen at full width), so (c) checks a float32 copy
ZOO_DECODE_TOL = (0.03, 0.05)
ZOO_OTHERS = (2, 64, 4)         # (c): requests, prompt tokens, decode steps
# (c)'s depth cuts (None: whole); every width as published
ZOO_DEPTH = {"gemma2-27b": 2, "starcoder2-15b": 2, "starcoder2-3b": 2,
             "mixtral-8x22b": 1, "grok-1-314b": 1, "internvl2-76b": 1,
             "falcon-mamba-7b": 2, "zamba2-2.7b": 12, "seamless-m4t-medium": None}
ZOO_GATED = ("dense", "ssm")    # families whose decode must equal apply in (c)


def _tree_float32(tree):
    if isinstance(tree, dict):
        return {k: _tree_float32(v) for k, v in tree.items()}
    return tree.to(torch.float32) if tree.is_floating_point() else tree


def zoo_cfg(name: str, n_layers=None):
    import dataclasses

    from repro_torch import configs
    cfg = configs.get(name)
    return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=n_layers)


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _tree_copy(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_copy(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def _synced(fn, device):
    """(fn(), seconds) on the host clock, synchronized on a card."""
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def zoo_inputs(cfg, batch: int, prompt: int, seed: int, device: str):
    """Seeded inputs: (prompt token ids, stub frontend embeds or None); for
    enc-dec (first target token, stub source frame embeds)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if cfg.family == "encdec":
        return (torch.randint(0, cfg.vocab, (batch, 1), generator=gen, device=device),
                torch.randn((batch, prompt, cfg.d_model), generator=gen, device=device,
                            dtype=dt))
    n_fe = cfg.n_frontend_tokens if cfg.frontend != "none" else 0
    fe = (torch.randn((batch, n_fe, cfg.d_model), generator=gen, device=device,
                      dtype=dt) if n_fe else None)
    return torch.randint(0, cfg.vocab, (batch, prompt), generator=gen,
                         device=device), fe


def zoo_serve(cfg, params, inputs, steps: int, device: str, check_apply: bool):
    """One architecture's serving path on ``device``: ``make_prefill_step``
    (timed), ``greedy_decode_loop`` for ``steps`` tokens from a copy of the
    prefill cache (timed), the same steps one ``make_decode_step`` call at a
    time, synchronized, from another copy (each step's wall and logits;
    its tokens must equal the loop's), and, with ``check_apply``, ``apply``
    on the prompt and the fed tokens (teacher forcing): its logits at the
    prefill's last position and at each decoded one against the serving
    path's.  Requires finite logits of the reference's shapes."""
    from repro_torch.launch import serve
    from repro_torch.models import encdec, lm

    b = inputs[0].shape[0]
    vocab = lm.padded_vocab(cfg)
    if cfg.family == "encdec":
        first, src = inputs
        s_total = 0
        max_len = steps
        cache, prefill_s = _synced(
            lambda: serve.make_prefill_step(cfg, max_len)(params, src), device)
        last = None
    else:
        tokens, fe = inputs
        s_total = tokens.shape[1] + (0 if fe is None else fe.shape[1])
        max_len = s_total + steps
        (last, cache), prefill_s = _synced(
            lambda: serve.make_prefill_step(cfg, max_len)(params, tokens, fe), device)
        first = torch.argmax(last[:, -1], dim=-1)[:, None]
    stepwise_cache = _tree_copy(cache, device)
    (greedy, _), loop_s = _synced(lambda: serve.greedy_decode_loop(
        params, cfg, _tree_copy(cache, device), first, s_total, steps), device)
    step = serve.make_decode_step(cfg)
    token, fed, logits, walls = first, [], [], []
    for i in range(steps):
        fed.append(token)
        (lg, stepwise_cache), s = _synced(
            lambda: step(params, token, stepwise_cache, s_total + i), device)
        logits.append(lg)
        walls.append(s)
        token = torch.argmax(lg[:, -1], dim=-1)[:, None]
    logits = torch.cat(logits, dim=1)
    stepwise = torch.argmax(logits, dim=-1)
    if not torch.equal(stepwise, greedy):
        raise AssertionError(f"zoo {cfg.name}: greedy_decode_loop gave {greedy.tolist()}, "
                             f"the stepwise decode {stepwise.tolist()}")
    want = (b, steps, vocab)
    if logits.shape != want or (last is not None and last.shape != (b, 1, vocab)) or \
            not torch.isfinite(logits).all() or \
            (last is not None and not torch.isfinite(last).all()):
        raise AssertionError(f"zoo {cfg.name}: decode logits {tuple(logits.shape)} "
                             f"(want {want}), finite {bool(torch.isfinite(logits).all())}")
    out = {"prefill_s": prefill_s, "greedy_loop_s": loop_s, "step_s": walls,
           "step_median_s": statistics.median(walls), "tokens": greedy.tolist(),
           "cache_bytes": _tree_bytes(cache), "max_len": max_len}
    if check_apply:
        fed = torch.cat(fed, dim=1)
        if cfg.family == "encdec":
            full = encdec.apply(params, src, fed, cfg)
            got = logits
        else:
            full = lm.apply(params, torch.cat([tokens, fed], dim=1), cfg, fe)[
                :, s_total - 1:]
            got = torch.cat([last, logits], dim=1)
        out["apply_logits"] = full
        atol, rtol = ZOO_DECODE_TOL
        err = (got.float() - full.float()).abs()
        out["decode_vs_apply_max_abs_err"] = float(err.max())
        out["decode_vs_apply_ok"] = bool((err <= atol + rtol * full.float().abs()).all())
        if not torch.isfinite(full).all():
            raise AssertionError(f"zoo {cfg.name}: apply's logits not finite")
    out["logits"] = torch.cat([logits] if last is None else [last, logits], dim=1)
    return out


def zoo_phase(smi: str):
    """The plaintext model zoo's serving path (``launch.serve``: prefill, the
    greedy loop, decode steps; ``models.lm`` / ``models.encdec``), plain
    torch ops on the card, TF32 off.  (a) ``ZOO_ARCH`` at full width and
    depth in bfloat16, seeded weights: ``ZOO_SERVE`` (requests, prompt,
    greedy tokens): the prefill wall, the greedy loop's wall and tokens/s,
    the warm per-token decode wall (median of synchronized steps), one
    decode step under torch.profiler (device busy share and op count),
    parameter and cache bytes; (b) the same model in float32 (``ZOO_F32``)
    on the card and on the host's CPU: the serving path's and ``apply``'s
    logits within ``ZOO_F32_TOL``,
    greedy tokens equal, and on both, decode equal to ``apply`` with the
    fed tokens within ``ZOO_DECODE_TOL``; (c) each other architecture at
    full width, depth cut as ``ZOO_DEPTH`` says, bfloat16: prefill
    ``ZOO_OTHERS``, then its decode steps; finite logits of the
    reference's shapes; decode against ``apply`` reported, and for the
    ``ZOO_GATED`` families required within ``ZOO_DECODE_TOL`` on a float32
    copy of the same weights; memory freed before the next.  The
    path launches none of the port's kernels (counters zeroed before and
    read after)."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import encdec, lm

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("zoo: TF32 must be off for the float32 checks")
    ops.reset_launches()
    record = {"card": smi}
    # (a) full depth, bfloat16
    cfg = zoo_cfg(ZOO_ARCH)
    b, prompt, steps = ZOO_SERVE
    with torch.inference_mode():
        params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0))
        inputs = zoo_inputs(cfg, b, prompt, 1, "cuda")
        cold = zoo_serve(cfg, params, inputs, 2, "cuda", False)   # first calls
        run = zoo_serve(cfg, params, inputs, steps, "cuda", False)
        token = torch.tensor(run["tokens"], device="cuda")[:, -1:]
        cache = serve.make_prefill_step(cfg, prompt + steps + 1)(params, inputs[0])[1]
        step = serve.make_decode_step(cfg)
        prof = _profiled(lambda: step(params, token, cache, prompt), again=True)
    tok_s = b * steps / run["greedy_loop_s"]
    a = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
         "requests": b, "prompt": prompt, "steps": steps,
         "param_bytes": _tree_bytes(params), "cache_bytes": run["cache_bytes"],
         "first_prefill_s": cold["prefill_s"], "prefill_s": run["prefill_s"],
         "greedy_loop_s": run["greedy_loop_s"], "tokens_per_s": tok_s,
         "decode_step_median_s": run["step_median_s"],
         "decode_step_s": run["step_s"], "decode_step_profile": prof}
    print(f"zoo (a) {cfg.name} full width and depth ({cfg.n_layers} layers), "
          f"bfloat16, seeded weights [{smi}]: {a['param_bytes']} B of params, "
          f"cache {a['cache_bytes']} B ({b} x {prompt + steps} slots); prefill {b} x "
          f"{prompt} tokens {run['prefill_s']:.4f} s (first call "
          f"{cold['prefill_s']:.4f} s); greedy_decode_loop {steps} tokens "
          f"{run['greedy_loop_s']:.4f} s = {tok_s:.1f} tokens/s; decode step "
          f"(synchronized) median {run['step_median_s'] * 1e3:.3f} ms "
          f"(min {min(run['step_s']) * 1e3:.3f}, max {max(run['step_s']) * 1e3:.3f}); "
          f"one decode step profiled: device busy {prof['device_busy_share']:.3f} of "
          f"{prof['span_s'] * 1e3:.3f} ms, {prof['device_ops']} device ops; top "
          f"{prof['top_device_ops_us'][:3]}", flush=True)
    record["a"] = a
    del params, cache, run, cold
    torch.cuda.empty_cache()

    # (b) float32, the card against the host's CPU
    cfg32 = dataclasses.replace(zoo_cfg(ZOO_ARCH), dtype="float32")
    b, prompt, steps = ZOO_F32
    runs = {}
    with torch.inference_mode():
        params = lm.init(cfg32, torch.Generator(device="cuda").manual_seed(2))
        inputs = zoo_inputs(cfg32, b, prompt, 3, "cuda")
        for where, dev in (("card", "cuda"), ("cpu", "cpu")):
            p = _tree_copy(params, dev)
            x = tuple(None if t is None else t.to(dev) for t in inputs)
            runs[where] = zoo_serve(cfg32, p, x, steps, dev, True)
            del p
    atol, rtol = ZOO_F32_TOL
    f32_err, f32_ok = 0.0, True
    for key in ("logits", "apply_logits"):
        got, want = runs["card"][key].cpu(), runs["cpu"][key]
        f32_err = max(f32_err, float((got - want).abs().max()))
        f32_ok &= bool(((got - want).abs() <= atol + rtol * want.abs()).all())
    bb = {"arch": cfg32.name, "dtype": "float32", "requests": b, "prompt": prompt,
          "steps": steps, "card_vs_cpu_max_abs_err": f32_err, "tol": list(ZOO_F32_TOL),
          "tokens_equal": runs["card"]["tokens"] == runs["cpu"]["tokens"],
          "tokens": runs["card"]["tokens"]}
    for where in ("card", "cpu"):
        r = runs[where]
        bb[where] = {k: r[k] for k in ("prefill_s", "greedy_loop_s", "step_median_s",
                                       "decode_vs_apply_max_abs_err",
                                       "decode_vs_apply_ok")}
    print(f"zoo (b) {cfg32.name} float32, {b} x {prompt} tokens + {steps} decode "
          f"steps [{smi}]: card vs CPU logits (serving and apply) max |diff| "
          f"{f32_err:.3g} (atol {atol}, "
          f"rtol {rtol}), greedy tokens equal {bb['tokens_equal']}; decode vs apply "
          f"max |diff| card {bb['card']['decode_vs_apply_max_abs_err']:.3g}, CPU "
          f"{bb['cpu']['decode_vs_apply_max_abs_err']:.3g} (atol {ZOO_DECODE_TOL[0]}, "
          f"rtol {ZOO_DECODE_TOL[1]}); card prefill {bb['card']['prefill_s']:.4f} s, "
          f"decode step median {bb['card']['step_median_s'] * 1e3:.3f} ms; CPU "
          f"prefill {bb['cpu']['prefill_s']:.4f} s, decode step median "
          f"{bb['cpu']['step_median_s'] * 1e3:.3f} ms", flush=True)
    if not (f32_ok and bb["tokens_equal"] and bb["card"]["decode_vs_apply_ok"]
            and bb["cpu"]["decode_vs_apply_ok"]):
        raise AssertionError(f"zoo (b): {bb}")
    record["b"] = bb
    del params, runs, got, want
    torch.cuda.empty_cache()

    # (c) the other architectures at full width
    b, prompt, steps = ZOO_OTHERS
    record["c"] = []
    torch.cuda.reset_peak_memory_stats()
    for seed, (name, depth) in enumerate(ZOO_DEPTH.items(), start=10):
        cfg = zoo_cfg(name, depth)
        model = encdec if cfg.family == "encdec" else lm
        t0 = time.perf_counter()
        gated = cfg.family in ZOO_GATED
        with torch.inference_mode():
            params = model.init(cfg, torch.Generator(device="cuda").manual_seed(seed))
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            inputs = zoo_inputs(cfg, b, prompt, seed + 100, "cuda")
            r = zoo_serve(cfg, params, inputs, steps, "cuda", True)
            if gated:     # the same weights and inputs in float32
                r32 = zoo_serve(dataclasses.replace(cfg, dtype="float32"),
                                _tree_float32(params), inputs, steps, "cuda", True)
        c = {"arch": name, "family": cfg.family, "layers": cfg.n_layers,
             "enc_layers": cfg.n_enc_layers, "cut": depth is not None,
             "param_bytes": _tree_bytes(params), "init_s": init_s,
             "peak_bytes": torch.cuda.max_memory_allocated(),
             **{k: r[k] for k in ("prefill_s", "greedy_loop_s", "step_median_s",
                                  "cache_bytes", "decode_vs_apply_max_abs_err",
                                  "decode_vs_apply_ok")},
             "float32_decode_vs_apply_max_abs_err":
                 r32["decode_vs_apply_max_abs_err"] if gated else None,
             "decode_vs_apply_gated": gated, "wall_s": time.perf_counter() - t0}
        print(f"zoo (c) {name} [{cfg.family}] full width, "
              f"{'depth cut to ' if depth is not None else 'whole, '}"
              f"{cfg.n_layers} layers{f' + {cfg.n_enc_layers} encoder' if cfg.n_enc_layers else ''}"
              f"{f', {prompt} stub audio frames' if cfg.family == 'encdec' else ''}"
              f"{f', {cfg.n_frontend_tokens} stub {cfg.frontend} tokens' if cfg.frontend == 'vision' else ''}"
              f", bfloat16 [{smi}]: {c['param_bytes']} B of params (init {init_s:.2f} s), "
              f"prefill {b} x {prompt} {r['prefill_s']:.4f} s, {steps} decode steps "
              f"(loop) {r['greedy_loop_s']:.4f} s, step median "
              f"{r['step_median_s'] * 1e3:.3f} ms; decode vs apply max |diff| "
              f"{r['decode_vs_apply_max_abs_err']:.3g} (reported)"
              + (f", float32 copy {r32['decode_vs_apply_max_abs_err']:.3g} (required "
                 f"within atol {ZOO_DECODE_TOL[0]}, rtol {ZOO_DECODE_TOL[1]}: "
                 f"{r32['decode_vs_apply_ok']})" if gated else ""), flush=True)
        record["c"].append(c)
        if gated and not r32["decode_vs_apply_ok"]:
            raise AssertionError(f"zoo (c) {name}: decode vs apply {c}")
        del params, r, inputs
        r32 = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    counts = ops.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"zoo: the path launched the port's kernels {counts}")
    return record


# ---------------------------------------------------------------------------
# train: the training path (no kernel of the port's own)
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_PARAMS = 619446272        # the config's param_count at full width
TRAIN_SHAPE = (4, 512)          # (a): batch, tokens per sequence
TRAIN_STEPS = 6                 # (a): timed steps after one warm-up step
TRAIN_F32 = (2, 2, 64)          # (c): depth, batch, tokens per sequence
# (c): card vs CPU in float32, stated before the first run: the loss
# within 1e-5 relative, each gradient leaf's max |diff| within 1e-4 of the
# leaf's largest CPU magnitude (summation orders differ, TF32 off)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_REL = 1e-4
# (c): microbatches 2 against 1, tests/test_system.py's tolerance
TRAIN_MICRO_TOL = {"loss_rtol": 1e-4, "atol": 1e-4, "rtol": 1e-3}
TRAIN_RESTART = (8, 4, 6)       # (d): total steps, checkpoint every, fail at


def _tree_equal(a, b) -> bool:
    from repro_torch.train.optimizer import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _train_step_timed(step_fn, state, batch):
    """(new state, loss, synchronized seconds) of one step."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    return state, loss, time.perf_counter() - t0


def _peak_of(fn):
    """(fn(), peak bytes allocated while it ran)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated()


def train_main(smi: str):
    """(a) and (b): full-width, full-depth Qwen1.5-0.5B steps."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import train as train_lib
    from repro_torch.runtime import op_analyzer, roofline
    from repro_torch.train import optimizer as opt_lib

    cfg = zoo_cfg(TRAIN_ARCH)
    b, s = TRAIN_SHAPE
    opt = opt_lib.AdamW()
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=s, batch=b)
    base = torch.cuda.memory_allocated()    # what earlier phases still hold
    state = train_lib.init_state(cfg, opt, torch.Generator(device="cuda").manual_seed(0))
    n_leaves = sum(p.numel() for p in opt_lib.tree_leaves(state.params))
    if cfg.param_count() != TRAIN_PARAMS:
        raise AssertionError(f"train: {cfg.name} counts {cfg.param_count()} params")
    batches = [pipe.batch_at(i, device="cuda") for i in range(TRAIN_STEPS + 1)]
    step_fn = train_lib.make_train_step(cfg, opt)
    state, loss0, warm_s = _train_step_timed(step_fn, state, batches[0])
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [loss0], []
    for batch in batches[1:]:
        state, loss, wall = _train_step_timed(step_fn, state, batch)
        losses.append(loss)
        walls.append(wall)
    peak = torch.cuda.max_memory_allocated()
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        raise AssertionError(f"train (a): losses {losses}")
    median = statistics.median(walls)
    shape = ShapeConfig("chip_smoke_train", s, b, "train")
    mflops = roofline.model_flops(cfg, shape)
    batch = batches[-1]
    prof = _profiled(lambda: step_fn(state, batch), again=True)
    host = host_profile(lambda: step_fn(state, batch))
    counted = op_analyzer.analyze(step_fn, state, batch)
    terms = roofline.roofline_terms(cfg, shape, counted, 1)
    remat = {}
    for mode in ("none", "full"):
        fn = train_lib.make_train_step(dataclasses.replace(cfg, remat=mode), opt)
        # the new state is dropped inside, so no mode's result outlives it
        (loss, wall), peak_r = _peak_of(lambda: _train_step_timed(fn, state, batch)[1:])
        remat[mode] = {"wall_s": wall, "peak_bytes": peak_r - base, "loss": loss}
    a = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
         "remat": cfg.remat, "params": cfg.param_count(), "param_elements": n_leaves,
         "batch": b, "seq": s, "losses": losses, "warmup_s": warm_s,
         "step_s": walls, "step_median_s": median, "tokens_per_s": b * s / median,
         "peak_bytes": peak - base, "held_before_bytes": base, "profile": prof,
         "host_profile": host,
         "model_flops": mflops,
         "model_flop_bound_s": mflops / roofline.PEAK_FLOPS,
         "model_flop_fraction": roofline.model_flop_fraction(mflops, median),
         "op_analyzer": {"flops": counted.flops, "bytes": counted.bytes,
                         "collective_bytes": counted.collective_bytes,
                         "ops": sum(counted.op_counts.values()),
                         "flops_over_6nd": counted.flops / mflops},
         "roofline": terms, "remat_other": remat}
    print(f"train (a) {cfg.name} full width and depth ({cfg.n_layers} layers, "
          f"{cfg.param_count()} params, float32 masters, {cfg.dtype} compute, remat "
          f"{cfg.remat!r}), AdamW, {b} x {s} tokens a step, seeded weights [{smi}]: "
          f"losses {[round(x, 4) for x in losses]}; warm-up step {warm_s:.3f} s; "
          f"{TRAIN_STEPS} synchronized steps median {median * 1e3:.2f} ms (min "
          f"{min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}) = "
          f"{a['tokens_per_s']:.0f} tokens/s; peak {peak - base} B allocated above "
          f"the {base} B held before the phase; one step "
          f"profiled: device busy {prof['device_busy_share']:.3f} of "
          f"{prof['span_s'] * 1e3:.1f} ms, {prof['device_ops']} device ops, top "
          f"{prof['top_device_ops_us'][:3]}; one step under cProfile "
          f"{host['total_s']:.3f} s of host time, top {host['top'][:4]}; "
          f"6·N·D = {mflops:.4g} FLOP, bound "
          f"{a['model_flop_bound_s'] * 1e3:.3f} ms at {roofline.PEAK_FLOPS:.4g} FLOP/s "
          f"({roofline.CARD}): model-FLOP fraction {a['model_flop_fraction']:.4f}; "
          f"op_analyzer: {counted.flops:.4g} FLOP ({a['op_analyzer']['flops_over_6nd']:.3f}"
          f" x 6·N·D), {counted.bytes:.4g} B, {a['op_analyzer']['ops']} aten ops, "
          f"dominant {terms['dominant']}; one step each (peak above the same base): "
          f"remat 'none' {remat['none']['wall_s'] * 1e3:.2f} ms, peak "
          f"{remat['none']['peak_bytes']} B; 'full' {remat['full']['wall_s'] * 1e3:.2f} "
          f"ms, peak {remat['full']['peak_bytes']} B", flush=True)

    # (b) the same step twice from one state, deterministic algorithms on
    torch.use_deterministic_algorithms(True)
    try:
        s1, m1 = step_fn(state, batch)
        s2, m2 = step_fn(state, batch)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    det = {"params_equal": _tree_equal(s1.params, s2.params),
           "opt_state_equal": _tree_equal(s1.opt_state, s2.opt_state),
           "loss_equal": bool(torch.equal(m1["loss"], m2["loss"])),
           "params_moved": not _tree_equal(s1.params, state.params),
           "loss": float(m1["loss"])}
    print(f"train (b) {cfg.name} full width, one step twice from one state under "
          f"torch.use_deterministic_algorithms(True), CUBLAS_WORKSPACE_CONFIG="
          f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')} [{smi}]: {det}", flush=True)
    if not all(det[k] for k in ("params_equal", "opt_state_equal", "loss_equal",
                                "params_moved")):
        raise AssertionError(f"train (b): not bitwise deterministic {det}")
    return a, det


def train_card_vs_cpu(smi: str):
    """(c): depth 2, float32: loss and gradients card against CPU; then
    microbatches 2 against 1 on the card."""
    import dataclasses

    from repro_torch.data import TokenPipeline
    from repro_torch.launch import train as train_lib
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt_lib

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("train (c): TF32 must be off")
    depth, b, s = TRAIN_F32
    cfg = dataclasses.replace(zoo_cfg(TRAIN_ARCH, depth), dtype="float32")
    params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(3))
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=s, batch=b).batch_at(0, device="cuda")
    out = {}
    for where in ("cuda", "cpu"):
        p = opt_lib.tree_map(lambda t: t.to(where, copy=True).requires_grad_(True), params)
        x = {k: v.to(where) for k, v in batch.items()}
        (loss, grads), wall = _synced(lambda: train_lib.value_and_grad(p, x, cfg), where)
        out[where] = (float(loss), [g.detach().cpu() for g in grads], wall)
        del p, grads
    (l_card, g_card, w_card), (l_cpu, g_cpu, w_cpu) = out["cuda"], out["cpu"]
    worst = max(float((a - c).abs().max()) / max(float(c.abs().max()), 1e-30)
                for a, c in zip(g_card, g_cpu))
    c = {"depth": depth, "batch": b, "seq": s, "loss_card": l_card, "loss_cpu": l_cpu,
         "loss_rel_err": abs(l_card - l_cpu) / abs(l_cpu), "grad_leaves": len(g_cpu),
         "worst_grad_rel_err": worst, "card_s": w_card, "cpu_s": w_cpu,
         "tol": {"loss_rtol": TRAIN_LOSS_RTOL, "grad_rel": TRAIN_GRAD_REL}}
    c["ok"] = c["loss_rel_err"] <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_REL
    del out, g_card, g_cpu

    # microbatches 2 against 1, SGD without momentum (the reference's test)
    cfg_n = dataclasses.replace(cfg, remat="none")
    sgd = opt_lib.SGD(schedule=opt_lib.Schedule(peak_lr=0.1, warmup_steps=0,
                                                decay_steps=0), momentum=0.0)
    state = train_lib.TrainState(params, sgd.init(params), torch.zeros((), dtype=torch.int32))
    s1, m1 = train_lib.make_train_step(cfg_n, sgd, 1)(state, batch)
    s2, m2 = train_lib.make_train_step(cfg_n, sgd, 2)(state, batch)
    tol = TRAIN_MICRO_TOL
    micro_err = max(float((x - y).abs().max()) for x, y in
                    zip(opt_lib.tree_leaves(s1.params), opt_lib.tree_leaves(s2.params)))
    c["micro"] = {"loss_1": float(m1["loss"]), "loss_2": float(m2["loss"]),
                  "params_max_abs_diff": micro_err,
                  "ok": abs(float(m1["loss"]) - float(m2["loss"]))
                  <= tol["loss_rtol"] * abs(float(m1["loss"])) and all(
                      bool(torch.allclose(x, y, atol=tol["atol"], rtol=tol["rtol"]))
                      for x, y in zip(opt_lib.tree_leaves(s1.params),
                                      opt_lib.tree_leaves(s2.params)))}
    print(f"train (c) {cfg.name} full width, depth {depth}, float32, TF32 off, "
          f"{b} x {s} tokens [{smi}]: loss card {l_card:.8f} CPU {l_cpu:.8f} (rel "
          f"{c['loss_rel_err']:.3g}, limit {TRAIN_LOSS_RTOL}); worst of "
          f"{c['grad_leaves']} gradient leaves max |diff| / max |CPU| "
          f"{worst:.3g} (limit {TRAIN_GRAD_REL}); card {w_card:.3f} s, CPU "
          f"{w_cpu:.3f} s; microbatches 2 vs 1: loss {c['micro']['loss_2']:.8f} vs "
          f"{c['micro']['loss_1']:.8f}, params max |diff| {micro_err:.3g} "
          f"(tolerance {tol})", flush=True)
    if not (c["ok"] and c["micro"]["ok"]):
        raise AssertionError(f"train (c): {c}")
    return c


def train_restart(smi: str):
    """(d): the reference's restart test on the card."""
    import dataclasses
    import shutil

    from repro_torch.data import TokenPipeline
    from repro_torch.train import loop as loop_lib, optimizer as opt_lib

    cfg = dataclasses.replace(zoo_cfg(TRAIN_ARCH + "-smoke"), n_layers=2)
    total, every, fail = TRAIN_RESTART
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=32, batch=4)
    opt = opt_lib.AdamW()
    base = os.path.join(ROOT, "build", "train_restart")
    shutil.rmtree(base, ignore_errors=True)
    straight, broken = os.path.join(base, "straight"), os.path.join(base, "broken")
    t0 = time.perf_counter()
    rep1 = loop_lib.run(cfg, pipe, loop_lib.LoopConfig(
        total_steps=total, ckpt_every=100, ckpt_dir=straight, async_ckpt=False),
        optimizer=opt, device="cuda")
    lc = loop_lib.LoopConfig(total_steps=total, ckpt_every=every, ckpt_dir=broken,
                             async_ckpt=False)
    try:
        loop_lib.run(cfg, pipe, lc, optimizer=opt, hooks={"fail_at": fail},
                     device="cuda")
        raise AssertionError("train (d): the injected failure did not raise")
    except RuntimeError as e:
        failure = str(e)
    rep2 = loop_lib.run(cfg, pipe, lc, optimizer=opt, device="cuda")
    s1, _ = loop_lib.elastic_restore(straight, cfg, opt, device="cuda")
    s2, _ = loop_lib.elastic_restore(broken, cfg, opt, device="cuda")
    on_cpu, _ = loop_lib.elastic_restore(broken, cfg, opt, device="cpu")
    d = {"arch": cfg.name, "layers": cfg.n_layers, "failure": failure,
         "resumed_from": rep2.resumed_from, "final_step": rep2.final_step,
         "losses_straight": rep1.losses, "losses_resumed": rep2.losses,
         "params_equal": _tree_equal(s1.params, s2.params),
         "opt_state_equal": _tree_equal(s1.opt_state, s2.opt_state),
         "cpu_restore_equal": _tree_equal(
             opt_lib.tree_map(lambda t: t.cpu(), s2.params), on_cpu.params),
         "cpu_restore_device": str(opt_lib.tree_leaves(on_cpu.params)[0].device),
         "wall_s": time.perf_counter() - t0}
    print(f"train (d) {cfg.name} at {cfg.n_layers} layers on the card [{smi}]: "
          f"{total} steps straight against checkpoint every {every}, failure at "
          f"{fail} ({failure!r}), resumed from {rep2.resumed_from}: params equal "
          f"{d['params_equal']}, moments equal {d['opt_state_equal']}; the card's "
          f"checkpoint restored onto {d['cpu_restore_device']} equal "
          f"{d['cpu_restore_equal']}; {d['wall_s']:.2f} s", flush=True)
    shutil.rmtree(base, ignore_errors=True)
    if not (d["resumed_from"] == every and d["final_step"] == total
            and d["params_equal"] and d["opt_state_equal"] and d["cpu_restore_equal"]):
        raise AssertionError(f"train (d): {d}")
    return d


def train_phase(smi: str):
    """The training path on the card (phase 19 of the docstring); the port's
    kernel counters zeroed before and read after: none may launch."""
    from repro_torch.kernels import ops

    ops.reset_launches()
    record = {"card": smi}
    record["a"], record["b"] = train_main(smi)
    torch.cuda.empty_cache()
    record["c"] = train_card_vs_cpu(smi)
    torch.cuda.empty_cache()
    record["d"] = train_restart(smi)
    counts = ops.launch_counts()
    record["launches"] = counts
    if any(counts.values()):
        raise AssertionError(f"train: the path launched the port's kernels {counts}")
    return record


# ---------------------------------------------------------------------------
# dryrun: the dry run (no kernel of the port's own; nothing allocated)
# ---------------------------------------------------------------------------

DRYRUN_FLOPS_RTOL = 1e-3        # (a): against the train phase's op_analyzer count
DRYRUN_PEAK_RTOL = 0.15         # (a): against the train phase's measured peak
# (b): layers of Qwen1.5-0.5B traced on the (16, 16) mesh; at full depth the
# trace takes about 120 s of one CPU core (the phase's limit is 45 s)
DRYRUN_MESH_DEPTH = 2
DRYRUN_WAIT_S = 300.0


def _dryrun_args():
    """(part -> dry-run command-line arguments) of the phase's four parts."""
    b, s = TRAIN_SHAPE
    return {
        "a": ["--arch", TRAIN_ARCH, "--kind", "train", "--global-batch", str(b),
              "--seq-len", str(s), "--mesh", "1x1"],
        "b": ["--arch", TRAIN_ARCH, "--shape", "train_4k", "--singlepod-only",
              "--override", json.dumps({"n_layers": DRYRUN_MESH_DEPTH})],
        "c": ["--mpc", "--mpc-arch", TRAIN_ARCH, "--mpc-budget", "8of64"],
        "d": ["--mpc", "--mpc-arch", "resnet18", "--mpc-budget", "8of64"],
    }


def _dryrun_schedules():
    """``plan.schedule()`` of (c) and (d), traced here on the meta device."""
    import torch as _torch

    from repro_torch.configs import RESNET18
    from repro_torch.core.hummingbird import HBConfig, HBLayer
    from repro_torch.launch import dryrun, specs
    from repro_torch.models import lm, resnet
    from repro_torch.train.optimizer import tree_map

    meta = lambda tree: tree_map(
        lambda leaf: _torch.empty(leaf.shape, dtype=_torch.float32, device="meta"), tree)
    cfg = zoo_cfg(TRAIN_ARCH)
    params = meta(specs.param_shapes(cfg, "serve"))
    plan = lm.trace(params, cfg, 1, 32)
    hb = HBConfig(tuple(HBLayer(k=21, m=13) for _ in range(plan.hb.n_groups)),
                  plan.hb.group_elements)
    lm_sched = lm.trace(params, cfg, 1, 32, hb=hb).schedule()
    rparams = meta(specs.shapes_of(lambda: resnet.init(RESNET18, device="cpu")))
    per_rank = dryrun.MPC_BATCH // dryrun.MPC_MESH["data"]
    r_sched = resnet.trace(rparams, RESNET18, per_rank,
                           hb=dryrun.hb_config_for(RESNET18, "8of64")).schedule()
    return {"c": (lm_sched.n_rounds, lm_sched.bytes_tx),
            "d": (r_sched.n_rounds, r_sched.bytes_tx)}


def dryrun_phase(smi: str, train: dict):
    """The dry run (phase 20 of the docstring): four processes at once,
    each writing its cell's JSON; checked against the train phase's
    record ``train`` and against ``plan.schedule()``."""
    import glob
    import shutil

    from repro_torch.kernels import ops

    ops.reset_launches()
    out_root = os.path.join(ROOT, "chiprun_out", "dryrun")
    shutil.rmtree(out_root, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    procs = {}
    for part, args in _dryrun_args().items():
        out = os.path.join(out_root, part)
        procs[part] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out", out],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    logs, walls = {}, {}
    try:
        for part, proc in procs.items():
            left = max(1.0, DRYRUN_WAIT_S - (time.perf_counter() - t0))
            logs[part] = proc.communicate(timeout=left)[0]
            walls[part] = time.perf_counter() - t0
            if proc.returncode:
                raise AssertionError(f"dryrun ({part}) exited {proc.returncode}:\n"
                                     f"{logs[part][-3000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    cells = {}
    for part in procs:
        files = sorted(glob.glob(os.path.join(out_root, part, "*.json")))
        if len(files) != 1:
            raise AssertionError(f"dryrun ({part}): {files}")
        with open(files[0]) as f:
            cells[part] = json.load(f)
    bad = {p: c.get("error") for p, c in cells.items() if c.get("status") != "ok"}
    if bad:
        raise AssertionError(f"dryrun: cells not ok {bad}")
    launched = {p: {k: v for k, v in c["kernel_launches"].items() if v}
                for p, c in cells.items()}
    a, b = cells["a"], cells["b"]
    want_flops = train["a"]["op_analyzer"]["flops"]
    want_peak = train["a"]["peak_bytes"]
    flops_err = abs(a["hlo"]["flops"] - want_flops) / want_flops
    peak_err = abs(a["memory"]["peak_bytes"] - want_peak) / want_peak
    scheds = _dryrun_schedules()
    got = {"c": (cells["c"]["lm"]["rounds"], cells["c"]["lm"]["bytes_tx"]),
           "d": (cells["d"]["mpc"]["rounds"], cells["d"]["mpc"]["bytes_tx"])}
    record = {"card": smi, "cells": cells, "part_wall_s": walls, "wall_s": wall,
              "a_flops_rel_err": flops_err, "a_peak_rel_err": peak_err,
              "train_flops": want_flops, "train_peak_bytes": want_peak,
              "schedules": scheds, "launches": launched,
              "tol": {"flops_rtol": DRYRUN_FLOPS_RTOL, "peak_rtol": DRYRUN_PEAK_RTOL}}
    print(f"dryrun (a) {TRAIN_ARCH} {TRAIN_SHAPE[0]} x {TRAIN_SHAPE[1]} tokens, remat "
          f"'dots', AdamW, a one-card mesh, {a['device']} fake tensors [{smi}]: FLOPs "
          f"{a['hlo']['flops']:.6g} against the train phase's {want_flops:.6g} (rel "
          f"{flops_err:.3g}, limit {DRYRUN_FLOPS_RTOL}); peak_bytes "
          f"{a['memory']['peak_bytes']} against the {want_peak} B measured (rel "
          f"{peak_err:.3g}, limit {DRYRUN_PEAK_RTOL}); {a['hlo']['aten_ops']} aten ops, "
          f"traced in {a['trace_s']} s", flush=True)
    print(f"dryrun (b) {TRAIN_ARCH} train_4k at depth {DRYRUN_MESH_DEPTH} on the "
          f"{b['mesh']} fake mesh of {b['n_chips']} ranks: {b['status']}; per card "
          f"{b['hlo']['flops']:.6g} FLOP, {b['hlo']['bytes']:.6g} B, collectives "
          f"{b['hlo']['collective_bytes']:.6g} B {b['hlo']['collectives']}, peak "
          f"{b['memory']['peak_bytes']} B; dominant {b['roofline']['dominant']} "
          f"(H100 datasheet peaks); traced in {b['trace_s']} s", flush=True)
    print(f"dryrun (c) {cells['c']['arch']} {cells['c']['shape']}: rounds / bytes "
          f"{got['c']} against plan.schedule() {scheds['c']}; (d) {cells['d']['arch']} "
          f"({cells['d']['mpc']['batch_per_rank']} images a rank): {got['d']} against "
          f"{scheds['d']}, pool {cells['d']['mpc']['pool_bytes_per_rank']} B a rank; "
          f"processes {({p: round(w, 1) for p, w in walls.items()})} s, the phase's "
          f"four at once {wall:.1f} s; launches {launched}", flush=True)
    if flops_err > DRYRUN_FLOPS_RTOL or peak_err > DRYRUN_PEAK_RTOL:
        raise AssertionError(f"dryrun (a): FLOPs rel {flops_err}, peak rel {peak_err}")
    if got != scheds:
        raise AssertionError(f"dryrun (c)/(d): {got} against {scheds}")
    counts = ops.launch_counts()
    if any(counts.values()) or any(launched.values()):
        raise AssertionError(f"dryrun: kernels launched {counts} {launched}")
    record["parent_launches"] = counts
    return record


PHASE_S: dict = {}


def _phase(name, fn, *args):
    """Run one phase; its seconds go to ``PHASE_S`` and the output."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = time.perf_counter() - t0
    print(f"phase {name}: {PHASE_S[name]:.1f} s", flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from repro_torch.kernels import build    # the port must be beside us

    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"build: {_phase('build', build.build_all):.1f} s", flush=True)

    lm = _phase("lm-setup", lm_setup)
    lm_long = _phase("lm-long-setup", lm_long_setups)
    rows, extra = _phase("kernels", kernel_phase, [lm] + lm_long)
    sass = sass_census()
    runs, launches = _phase("main-path", main_path_phase)
    per_call = sum(c for *_, c in RING_MATMUL_SHAPES)
    if set(launches["ring_matmul"].values()) != {per_call}:
        raise AssertionError(f"ring_matmul launched {launches['ring_matmul']} "
                             f"times, its shape table counts {per_call}")
    lm_runs, lm_path_launches = _phase("lm-path", lm_path_phase, lm)
    lm_relu = _phase("lm-relu", lm_relu_phase, lm)
    torch.cuda.empty_cache()
    lm_long_runs, lm_long_launches = _phase("lm-long", lm_long_phase, lm_long)
    del lm_long
    torch.cuda.empty_cache()
    ragged, ragged_launches = _phase("ragged-merge", ragged_merge_phase)
    for k, by_path in (list(ragged_launches.items()) + list(lm_path_launches.items())
                       + list(lm_long_launches.items())):
        launches.setdefault(k, {}).update(by_path)
    merge = _phase("merge", merge_phase, torch.empty(64 * 2 ** 20, dtype=torch.int32,
                                                     device="cuda").zero_)
    breakdown = _phase("stem-breakdown", stem_breakdown_phase)
    search, search_rows, search_launches = _phase("search", search_phase)
    for k, v in search_launches.items():
        launches.setdefault(k, {})["search"] = v
    served, serve_rows, serve_launches = _phase("serve", serve_phase)
    served_lm, serve_lm_launches = _phase("serve-lm", serve_lm_phase, lm)
    front, front_launches = _phase("frontend", frontend_phase)
    seed_oracle, seed_launches = _phase("seed-oracle", seed_oracle_phase)
    deploy, deploy_launches, deploy_s, deploy_sim = _phase("deploy", deploy_phase)
    deploy_rows = _phase("deploy-kernels", deploy_kernel_phase)
    examples, examples_launches, examples_rows = _phase("examples", examples_phase)
    mesh, mesh_launches = _phase("mesh", mesh_phase, deploy_s, deploy_sim,
                                 deploy["threads"])
    analysis = _phase("analysis", analysis_phase, deploy_s)
    del deploy_s, deploy_sim
    mesh_rows = _phase("mesh-kernels", mesh_kernel_phase)
    torch.cuda.empty_cache()
    zoo = _phase("zoo", zoo_phase, smi)
    torch.cuda.empty_cache()
    train = _phase("train", train_phase, smi)
    dry = _phase("dryrun", dryrun_phase, smi, train)
    for path, counts in (("serve", serve_launches), ("serve-lm", serve_lm_launches),
                         ("frontend", front_launches), ("seed-oracle", seed_launches),
                         ("deploy", deploy_launches), ("examples", examples_launches),
                         ("mesh", mesh_launches)):
        for k in SHAPE_KERNELS:
            launches.setdefault(k, {})[path] = counts.get(k, 0)
    extra += serve_rows + deploy_rows + examples_rows + mesh_rows
    search["per_call_sums"]["ring_matmul"] = next(
        r["per_call_sums"] for r in rows + extra
        if r["name"] == "ring_matmul" and "per_call_sums" in r)
    extra += search_rows
    for row in rows + extra:     # launches: the row's path; all paths beside
        row["launches"] = launches[row["name"]][row.pop("path")]
        row["launches_by_path"] = launches[row["name"]]
    PHASE_S["total"] = time.perf_counter() - t_start
    print(f"phase seconds: {json.dumps(PHASE_S)}", flush=True)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "device": device, "kernels": rows,
                   "kernels_other_shapes": extra, "ring_matmul_sass": sass,
                   "main_path": runs, "lm_path": lm_runs, "lm_relu": lm_relu,
                   "lm_long": lm_long_runs,
                   "ragged_merge": ragged,
                   "merge": merge,
                   "stem_breakdown": breakdown, "search": search,
                   "serve": served, "serve_lm": served_lm, "frontend": front,
                   "seed_oracle": seed_oracle, "deploy": deploy,
                   "examples": examples, "mesh": mesh,
                   "analysis": analysis, "zoo": zoo, "train": train,
                   "dryrun": dry, "phase_s": PHASE_S}, f, indent=1)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
