#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON object per line:

1. build    — nvcc builds ``csrc/bittide_fused.cu``,
              ``csrc/bittide_tiled.cu``, ``csrc/bittide_sparse.cu`` and
              ``csrc/bittide_step.cu`` in parallel; their ptxas reports
              (registers, shared memory, spills) and the card's
              ``nvidia-smi`` name and power limit are printed.
2. parity   — each kernel against its plain PyTorch version on the card.
              Fused (``PARITY_CASES``, each held to the plan the library
              reports): FC8 at B=64 and at 4·SMs·3 + 5 draws (the warp
              path, a partial last CTA) with two latency classes (row
              lists) and with one (the dense loop), torus3d(6) at B=16
              with two classes and with one (the block path's row
              lists), fully_connected(64) at B=16 (the block path's
              dense loop, A in shared memory), fully_connected(16) at
              B=64 with two classes (the warp path's dense loop, A in
              shared memory), torus3d(3) at B=40 with one class and two
              (27 nodes: lanes past a warp's draw); per-draw kp / lat /
              lamsum / holdover mask, 400 periods recorded every 20, all
              four variants, 0.0 error; ``NONFINITE_CASES``: one ψ
              seeded inf (the vote's dense periods), inf / NaN at the
              plain version's positions, watermarks included.  Tiled (``TILED_PARITY_CASES``): torus3d(8) at
              B=9 (two draw groups, the second partial) and torus3d(7)
              (ragged tiles, N % 4 != 0: the 4-byte copies) at B=5, one
              class and two (the second a single directed edge, so the
              stack is not symmetric); the ring's edges: torus3d(6) (fewer
              panels than ring stages) at B=3, and at B=4 with three
              classes (a class boundary inside the ring), torus3d(8) at
              B=17 (three draw groups, the last of one draw); every
              variant plus the guard with bands that trip at different
              records and with bands that never trip; 0.0 error.  The fused guard
              (``FUSED_GUARD_CASES``) with draws tripping at different
              records, so that the wrapper's replay runs: FC8 at B=64, and
              torus3d(8) at B=9 with two classes (N=512 > 256: 512 threads
              per CTA, A read from L2).  Sparse (``SPARSE_PARITY_CASES``):
              FC8 (K=7) at B=64, random_regular(300, 3, 0) at B=9 (the
              last CTA of each draw partial), the ragged
              bounded_degree_topo(96, 4, 3) with 2 isolated nodes and 2
              leaves, the same with K + 2 padded slots, and per-draw
              tables with a dropped link per draw (the direct pass), and
              torus3d(21) at B=235 with shared tables (the grouped pass);
              every variant and the guard tripping at different records
              and never; 0.0 error, each by the plan the library
              reports.
              Per-step (``PERSTEP_PARITY_CASES``): FC8, FC8 with the
              1000 m spool (two classes), the ragged torus3d(7) with a
              holdover mask, torus3d(6) with one class and with three, one
              draw each; every variant and the guard
              tripping at a mid record and never; 0.0 error, and the
              launches the C loop made.
              The tiled, sparse (direct and grouped) and per-step kernels
              on a diverged draw (``STREAM_NONFINITE_CASES``): ψ seeded
              inf, and a gain that overflows after a record or more;
              every variant bit for bit with the plain version, inf / NaN
              at its places in ν, β, ψ and all four watermark arrays (the
              diverging rows' records tell a NaN-dropping fold apart).
3. fc8      — the main path at users' size: ``simulate_ensemble_dense`` on
              fully_connected(8), B=4096 draws in ±8 ppm, kp=2e-8,
              dt=5e-5, 10,000 steps recorded every 20, β + watermarks;
              256 draws held against the segment-sum lane on the card;
              the kernel's latency bound (``fused_latency_bound``) beside
              its operations bound.
4. torus    — torus3d(6), B=256, kp=2e-8, dt=1e-3, 2,000 steps,
              watermarks; 16 draws held against the segment-sum lane.
5. segsum   — the segment-sum lane: cube, B=64, the quickstart's discrete
              controller with quantized β, dt=1e-3, 2,000 steps; every
              draw must converge into the 1 ppm band.
6. tiled    — the tiled lane at Fig-18 size: ``simulate_ensemble_dense``
              on torus3d(22) (10,648 nodes, A = 453.5 MB), B=8 draws in
              ±8 ppm, 2 m cables, kp=2e-8, dt=5e-3, 2,000 periods recorded
              every 100, watermarks; ν against the segment-sum lane, and
              every draw converged.  The kernel's time per pass, the
              stack's bytes per pass over it against 3.35 TB/s, and its
              ring (stages, rows per CTA, sources per panel, CTAs per SM).
              A ``torch.matmul`` of the same shapes per pass is timed as a
              yardstick for the aggregation alone, and the kernel's TMA
              panel copies against its 4-byte ones (the same stack one
              float past a 16-byte boundary).

Phases 3, 4 and 6 (``run_main_path``) also time the kernel with CUDA events
on the main path's own inputs, check that one more launch reproduces the
main path's records bit for bit, hold it against the plain version over
every draw (phase 6: over 2 records × 2 periods with the measure pass at
the main path's launch layout), and time the host side of the call piece
by piece: the stack scatter, its copy to the card, the record copies back.

7. scenario — ``run_scenario`` (device default) on examples/cable_swap.py's
              scenario at its full 40,000 periods (FC8, dt=1e-4, records
              every 20, a re-establishing LatencyStep half way, β) over
              256 draws on the fused lane: launches, wall, memory, the
              RTT shift, and ν against the segment-sum lane at the smoke
              length (4,000 periods).  Then tests/test_reframing.py's
              torus case (torus3d(8), DriftRamp + LatencyStep,
              ReframePolicy(depth=16, margin=5.0)) on the tiled (auto) and
              the forced fused lane: identical splices and shifts,
              ``guard_latency == 1``, at least 3 splices.  Every engine
              call of these runs is held against the plain version on the
              call's own inputs (``hold_engine_calls``; the cable swap's
              1,000-record calls over their first 50 records).

8. sparse   — the sparse lane at full width: ``simulate_ensemble_dense``
              with ``engine="auto"`` (which must choose "sparse") on
              torus3d(100): 1,000,000 nodes, 6,000,000 edges, K=6; B=8
              draws in ±8 ppm, 2 m cables, kp=2e-8, dt=5e-3, 2,000
              periods recorded every 100, watermarks.  The kernel against
              the plain version over every draw at full depth (0.0
              error), one more launch reproducing the records, ν against
              the segment-sum lane within ``float32_floor_ppm``; kernel
              time, the host side piece by piece (the auto probe,
              ``ellify``, the λeff fold, tables to the card, records
              back), node-steps/s, memory, the final ν band; every
              pass's aggregation as two ``torch.sparse`` CSR products,
              timed over all the call's passes, as a yardstick (the port
              never calls it).  Then phase 6's run
              (torus3d(22) × 8 draws) on the sparse lane: both kernels'
              times side by side, every draw converged.
9. chaos    — two ``ChaosCampaign``s on the sparse lane, torus3d(8) ×
              1,024 draws: examples/chaos_campaign.py's full campaign
              (FreqStep / DriftRamp / LatencyStep samplers, 4,800 steps
              recorded every 24, ``auto_reframe=True``, depth 32; verdict
              counts, the shrunk repro must reproduce), and a
              LinkDropSampler + FreqStepSampler campaign (per-draw
              weight tables) within ``LINKDROP_ATOL_PPM`` (2e-5 ppm) of
              the segment-sum lane.  Campaign 1's wall is split by its
              flight recorder into the engine calls, triage and the rest.
              Every engine call is held against the plain version on its
              own inputs at 0.0 error.

10. perstep — the per-step lane (``bittide_perstep``, one draw and one
              launch per period).  (a) ``simulate_ensemble_dense(engine=
              "per-step")`` on phase 6's torus3d(22) (A = 453.5 MB), its
              draws 0 and 1, 2,000 periods recorded every 100,
              watermarks: launches (2 × (2,000 + 2 × 20)), the kernel's
              time per pass beside the bytes bound, the stack's bytes per
              pass over it against 3.35 TB/s and its ring, memory, one
              ``torch.mv`` per class as the yardstick of one period's
              aggregation, the plain version over 2 records × 2 periods at
              0.0 error, ν and watermarks bit-identical to phase 6's tiled
              rows.
              (b) ``BittideNetwork.run_scenario`` on phase 7's cable swap
              (40,000 periods, its first 16 draws): ν and β against phase
              7's fused rows, the same RTT shift; every engine call held
              against the plain version over its first 10 records.  (c)
              Phase 7's guarded torus with three draws whose drift rates
              differ, so that the host resync re-runs draws: splices
              identical to the fused lane's.  (The quickstart's flow,
              once its part (d), runs as phase 16's
              ``examples/torch_quickstart.py``.)

11. serve   — the bittide-paced serving simulator on the card.  (a)
              examples/serve_bittide.py at its full default: ring(8)
              workers at ``default_rng(7)`` speeds in ±50,000 ppm, the
              example's mid-serve faults over 60 s (FreqStep, DriftRamp,
              NodeHoldover / NodeReset, LinkDrop / LinkRestore),
              ``pace_workers`` (kp 5e-3, 10 steps/s, records every 5) on
              segment-sum and on the fused lane, 8 rps of diurnal +
              burst arrivals, smollm-135m with 8 slots at hw_flops 1e12,
              ``ServeConfig(8, 64, slo_s=30)``, queue depth 16; every
              discipline served on each lane.  (b) the ``serving_goodput``
              lane's configuration (benchmarks/serving_bench.py: 30 s, 6
              rps, its four events) on the fused lane.  (c)
              ``simulate_stragglers`` at tests/test_ft_straggler.py's case
              (ring(4), ±50,000 ppm on neighbours, 100 s), PI and
              proportional.  Every fused engine call held against the plain
              version at 0.0 error and timed with CUDA events; the fused
              lane's ν within ``float32_floor_ppm`` of segment-sum; bittide
              goodput ≥ barrier and p99 ≤ barrier in (a) and (b); request
              conservation at every tick, equal fingerprints on a second
              serve; in (c) the controlled peak under a fifth of the
              uncontrolled, the spread under 1e-3, ``bounded``.  The walls:
              each pace (its engine calls by the flight recorder, and the
              rest) and each discipline's serve.

12. models  — model serving through ``repro_torch.models.ModelZoo`` (no
              kernel of the port: the stack reaches no ``pallas_call`` in
              the reference), under ``torch.inference_mode()`` with the
              default matmul flags (printed).  (a) smollm-135m at full
              width and depth (30 layers, d 576, 9 / 3 heads, vocab
              49,152) on random weights from a seeded generator: 8
              requests of 2,048-token prompts (``attn_chunk`` 1,024: the
              chunked path), 32 greedy tokens by examples/serve_decode.py's
              widen-and-append loop; the prefill and decode times (CUDA
              events), tokens/s, peak memory, parameter count and bytes,
              and a decode step's bytes bounds (the arithmetic as written,
              with its per-call bf16 casts, and the function's own: the
              f32 parameters and the caches read once); ``torch.profiler`` over one
              prefill and four decode steps: the device's busy time, idle
              share and operations launched.  (b) prefill(1,023) +
              decode(1) against prefill(1,024)'s last logits: at rtol /
              atol 2e-2 with the depth cut to 2 layers (the same
              weights), and at full depth the greedy token wherever the
              forward's top-1 / top-2 margin exceeds 4e-2 (its error
              printed); for smollm at full depth, on one sequence, the
              card's parting within 1.5 x the port's on the CPU with the
              same weights (tests/test_torch_models_serving.py holds the
              CPU's within 1.5 x the reference's at full depth); the f8
              K/V cache within 2 % of the bf16 cache.  (c) mamba2-370m at
              full width and depth (48 layers,
              d 1,024, state 128, chunk 256): 4 requests of 1,024 tokens,
              16 greedy tokens, as (a), and (b)'s check.  (d) every
              architecture at ``.reduced()``: prefill and 4 decode steps
              from the same weights on the card and the CPU, logits at
              (b)'s bar, the greedy tokens equal wherever the CPU's top-1
              / top-2 margin exceeds 4e-2.

13. train   — the training path (``repro_torch.launch`` / ``optim`` /
              ``data`` / ``checkpoint``; no kernel of the port: the
              reference's training path reaches no ``pallas_call``).  (a)
              examples/train_bittide_cluster.py's step at its full width
              (its sync, ring schedule and stragglers run in phase 16,
              ``examples/torch_train_bittide_cluster.py``):
              smollm-135m at full width and depth (30 layers, d 576,
              vocab 49,152, tied head, f32 parameters) on seeded random
              weights, AdamW(lr 3e-3, weight decay 0.01), the example's
              step (``value_and_grad`` of ``train_loss``, then
              ``adamw_update``), 60 steps of 8 × 256 tokens from
              ``SyntheticPipeline(DataConfig(V, 256, 8, seed=0))``, an
              async ``CheckpointManager(keep=2)`` save of step 50 under
              ``build/``, restored into a fresh template: every leaf bit
              for bit, and the step-50 loss recomputed forward-only from
              it equal to the uninterrupted run's bit for bit.  The
              step's median CUDA-event ms over steps 10–59, tokens/s,
              peak memory, the loss every 10 steps, 6·N·D per step over
              the step time against the dense bf16 peak, and
              ``torch.profiler`` over three more steps (device busy, idle
              share, device operations per step); every loss finite, the
              last 10 losses' mean below the first 10's.  (b) mamba2-370m
              at full width and depth (48 layers, d 1,024, state 128,
              chunk 256), 4 × 256, 5 steps: the SSD scan's backward; as
              (a) without the checkpoint.  (c) every architecture at
              ``.reduced()``: ``train_loss`` and its gradients on the card
              against the CPU from the same weights and batch (loss within
              rel 2e-3, every gradient leaf within rtol 5e-2 / atol 5e-4,
              or, for a bf16 sum that cancels, that bar at the leaf's
              largest |gradient|: ``train_card_vs_cpu``), and one
              ``adamw_update`` on each given the CPU's gradients (within 2
              f32 ulps of each leaf's max |p|).  Its step-50 checkpoint
              stays under ``build/phase13_ckpt`` for phase 14.
14. mesh    — the distributed training path (``launch.mesh``,
              ``ft.elastic``, placements by ``pspec_tree``, the mesh step,
              ``sched.pipeline``, ``optim.compression``; no kernel) on a
              one-rank NCCL group (``HashStore``; NCCL takes one rank per
              card, so the multi-rank semantics are the CPU tests'
              on gloo): ``remesh([0], model_size=1)`` gives a (1, 1)
              ("data", "model") mesh; phase 13's step-50 smollm-135m
              checkpoint restored onto it with ``shardings``, every leaf
              bit for bit with a plain ``restore``; 5 steps of
              ``make_train_step`` on the mesh and 5 on plain tensors from
              the same state and batches (8 × 256, steps 50–54), the loss
              and every parameter and moment bit for bit after each; the
              step's CUDA-event ms of both, peak memory and all-reduces per
              step.  Under the ``tp`` profile this mesh step is the split
              step (``models.parallel``: each block on its "model" group
              of one rank, which issues no collective; the tied head
              row-parallel), and so is
              ``make_prefill_step`` on the same state (8 × 256 tokens):
              its logits and K/V caches bit for bit with the plain
              prefill, the CUDA-event ms of both; reduced llama3-8b
              (untied: the vocabulary-parallel loss and the gathered
              logits) takes 3 split steps and a split prefill, bit for
              bit with the plain ones.  The split decode: after the split
              prefill, 4 greedy steps of ``make_decode_step`` on the
              caches as ``cache_defs`` lays them out (the sequence "split"
              over the group of one, ``widen_mesh_caches`` between the
              steps) against ``ModelZoo.decode`` on ``widen_caches``, bit
              for bit, with the CUDA-event ms of both per step.
              pixtral-12b (the VLM family) at its full width and 2
              layers (bf16 parameters, seeded random weights): one split
              train step (2 × 2,048 tokens, patch embeddings over the
              first 1,024 positions), the split prefill and 2 split
              decode steps against the plain calls, bit for bit, with
              their ms; and so qwen2-moe-a2.7b (the MoE family: 64
              padded experts, top-4, a shared MLP of 5,632) at its full
              width and 2 layers, 2 × 1,024 tokens (one group of 2,048),
              routing, experts and shared MLP on the split, with the
              train step's peak memory; and so mamba2-370m (the SSM
              family: 32 heads of 64, state 128, ``in_proj``'s 4,384
              columns and the conv's 2,304 channels sliced to the
              rank's, the gated norm's Σy² on the group) at its full
              width and 4 layers, 4 × 1,024 tokens, the states on their
              heads (``ssm_split_bits``); and so zamba2-7b (the hybrid
              family: the shared block's ``w_in`` split on its output d
              and gathered, its 32 / 32 heads and d_ff 14,336 split, the
              Mamba2 groups and tail on their 112 heads) at its full
              width and 13 layers (2 groups of 6, so that the shared
              block's gradient sums two applications, and a tail of 1;
              1.47e9 parameters, bf16, f32 moments), 2 × 1,024 tokens,
              the ``shared_kv`` caches on their sequence, with the train
              step's peak memory (``hybrid_split_bits``); and so
              seamless-m4t-large-v2 (the encoder-decoder family: the
              encoder's and the decoder's 16 / 16 heads and d_ff 8,192
              split, the cross-attention column / row-parallel on its
              heads, vocabulary 256,206) at its full width and 2 encoder
              + 2 decoder layers (6.5e8 parameters with the embedding
              and the head, bf16, f32 moments), 2 × 1,024 tokens over
              2 × 1,024 source frames, ``kv`` on its sequence and
              ``cross_kv`` on the source's (``encdec_split_bits``).
              Then a save
              from the mesh,
              ``plan_mesh(1, 1)``, a restore
              through ``remesh`` and one more step, its loss bit for bit
              with the uninterrupted run's; ``ef_roundtrip`` and
              ``compressed_psum`` over every gradient leaf on the card, bit
              for bit with the same on the CPU (a gloo group), and on
              ``int8_scale_ties`` (a max whose quotient by 127 and
              product with fl(1/127) part, elements at halves of both
              int8 grids): the scale the quotient; a one-stage
              ``pipeline_apply`` of 8 microbatches of ``tanh(h @ w)`` at
              d 576, bit for bit with the chain, and ``plan``'s makespan
              and bubble for ring(4).  The group is destroyed, the
              checkpoints removed and the allocator's cache emptied.
15. launch  — the launch analysis (``launch.hloanalysis``,
              ``launch.memmodel``, ``launch.dryrun``; no kernel): (a) one
              real smollm-135m ``make_train_step`` step at phase 13's shape
              (8 × 256, phase 13's state at step 0 and its first batch)
              under the FLOP and bytes counters (``StepCounter``), whose
              FLOP count must equal the fake-tensor trace of the same step
              (``abstract_train_args`` with no mesh, fake CUDA tensors)
              exactly; the roofline terms (compute from the counted FLOPs
              over 989 TFLOP/s, memory per op and fused — memmodel at
              chips=1 — over 3.35 TB/s, collective 0) against phase 13's
              measured median step (the roofline fraction),
              ``MemTracker``'s predicted peak against phase 13's
              ``max_memory_allocated``, and the decode bytes over 3.35
              TB/s against phase 12's decode step (memmodel at chips=1,
              whose cache term is over the production mesh's model axis
              of 16, and one card's: the whole K/V cache); no step is
              timed again.  (b) ``dryrun.run_cell`` on a fake world of
              512 ranks with fake CUDA tensors: smollm-135m × train_4k
              (single pod, multi pod, roofline, driven from a thread
              beside (a)) and mamba2-370m × long_500k (after (a); the
              SSM family's split decode, each rank's heads of the
              states, beside its gathered decode, ``GATHERED_STEP``), each
              cell's four traces at once in worker processes (their
              fork server, started before phase 1, is stopped and
              waited for when the script exits); each cell's terms,
              dominant term,
              bytes per device and collectives printed; every cell
              traced, with FLOPs and collectives and nothing unmatched.
              smollm-135m × train_4k's step is the split step: its FLOPs
              and bytes per device beside the gathered step's
              (``GATHERED_STEP``: 1.412e14 FLOPs, 23.25 GB, as PERF.md §6
              records them), and the leaves it keeps gathered
              (the attention: 9 q heads on 16 ranks).  internlm2-1.8b ×
              decode_32k (after (a) and mamba2): the split decode,
              each rank's slice of the K/V caches' sequence; its FLOPs and
              bytes per device beside the decode that gathered the
              parameters and the caches (``GATHERED_STEP``).
              qwen2-moe-a2.7b × decode_32k: the MoE family's
              split decode (experts across the 16 "model" ranks, the
              token group of the global batch of 128 across the 16 data
              ranks), beside its gathered decode (``GATHERED_STEP``).
              zamba2-7b × decode_32k: the hybrid family's split
              decode (the ``shared_kv`` caches on their sequence, the
              shared block and the Mamba2 layers on the 16 "model"
              ranks), beside its gathered decode (``GATHERED_STEP``).
              seamless-m4t-large-v2 × decode_32k (last): the
              encoder-decoder family's split decode (``kv`` and
              ``cross_kv`` on their sequences, the decoder's blocks on
              the 16 "model" ranks), beside its gathered decode
              (``GATHERED_STEP``).

16. examples — every ``examples/torch_*.py`` through its ``main(argv)``
              on the card (``EXAMPLE_CARD_FORMS``): the quickstart; the
              cable swap's 40,000 periods once per ``--engine`` (auto →
              fused, fused, tiled, per-step, segment-sum); auto_reframe
              (2,880 periods, fused); ensemble_sweep at 32 draws (its
              dense lane: fused); scale_torus (k = 6, 10, 14, 22 on
              segment-sum, then torus3d(100) on the sparse kernel with
              watermarks); the chaos campaign on torus3d(8) × 4,800
              periods at 64 draws of its 1,024 (phase 9 runs two
              1,024-draw campaigns); serve_bittide's full default;
              serve_decode's default (reduced smollm-135m, 4 × 64, 32
              tokens); the training example (smollm-135m at full width,
              8 × 256) for 20 steps, then ``--resume`` to step 24 from its
              checkpoint under ``build/examples`` (removed after).  Each
              run with every wrapper's count set to 0 just before and read
              just after: one line per example with its launches, wall and
              printed lines; the fused, tiled, sparse and per-step kernels
              each launched from their examples; one engine call per kernel
              and form (a guarded one where the guard ran) held at 0.0 to
              its plain version.  Beside them, in a process of its own
              started with the phase (``examples_small_forms``), each
              example's smallest form (``EXAMPLE_SMALL_FORMS``:
              ``--smoke`` where the reference has one, ``sync_torus(6)``,
              4 draws, ``--tiny --steps 3``) on the card and then on the
              CPU, held to each other:
              integers, verdicts and strings equal, ν at
              ``FREQ_ATOL_PPM``, β and queue peaks at
              ``BETA_ATOL_CROSS_FRAMES``, convergence times equal but at
              named records within the bar of the band, losses at rel
              2e-3, greedy tokens where the CPU's top-two margin exceeds
              4e-2.

Then the kernels line (each kernel's ``examples_launches`` beside the
earlier phases' ``launches``), the card's ``nvidia-smi`` line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failure raises and ends the
run with a non-zero exit.  It exits 3 with no result when the port
(``src/repro_torch``) is not beside it, as when the script is copied
alone into an empty directory, and 2 without a CUDA card.
"""
import contextlib
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The bars of tests/engine_harness.py (tests/test_torch_package_rules.py
# checks that they agree).
FREQ_ATOL_PPM = 1e-6
BETA_ATOL_FRAMES = 1e-6
BETA_ATOL_CROSS_FRAMES = 2e-5
# tests/test_chaos.py's bar for a LinkDrop campaign on the sparse lane
# against segment-sum (re-establishment at kp = 2e-8 sets a float32
# floor); tests/test_torch_package_rules.py checks it too.
LINKDROP_ATOL_PPM = 2e-5

# H100 SXM peaks (NVIDIA data sheet): float32 without tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Cycle latencies of the fused kernel's latency bound, measured by
# scripts/torch_latency_probe.py on an NVIDIA H100 80GB HBM3 at 700 W
# (the least of five runs of 4,096 rounds): a dependent float32 add (a
# multiply takes 4.138); one synchronisation round of a period — x
# stored, the sync and its vote, a neighbour's x loaded — on the warp
# path through shared memory, on its shuffle path (one class, rows in
# registers: a __shfl_sync) and on the block path by CTA size in threads
# (a CTA between two sizes takes the smaller's); and the update's
# dependent chain after the row sum (err: 2, c: 1, ν': 2, ψ': 2, x: 1).
FP32_DEP_CYCLES = 4.117
SYNC_CYCLES = {"warp": 34.28, "shfl": 27.26}
BLOCK_SYNC_CYCLES = {64: 71.33, 128: 75.33, 216: 81.40, 512: 100.46,
                     1024: 145.93}
UPDATE_CHAIN_OPS = 8


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def two_class_links(topo):
    """2 m cables, plus 1000 m on both directions of the pair (0, 1)."""
    import numpy as np
    from repro_torch.core import make_links
    cable = np.full(topo.num_edges, 2.0)
    pair = ((topo.src == 0) & (topo.dst == 1)) | (
        (topo.src == 1) & (topo.dst == 0))
    cable[pair] = 1000.0
    return make_links(topo, cable_m=cable)


# Kernel-vs-plain cases of phase 2 and of the card tests: (topology,
# draws, latency classes), each with its fused plan (``launch_plan``).
# FC8 runs the warp path (four draws in the lanes of a warp): with two
# classes its rows hold 7 of 16 terms (row lists), with one 7 of 8 (the
# dense loop, A in shared memory).  "waves" stands for 4·SMs·3 + 5 draws
# of FC8: several warps per CTA and a partial last CTA.  torus3d(6) runs
# the block path on row lists, with two classes and with one (phase 4's
# main path); fully_connected(64) runs the block path's dense loop (A in
# shared memory), the dense fallback of the list plan, and
# fully_connected(16) with two classes (rows of 15 terms, too long for
# registers) the warp path's; torus3d(3) (27 nodes: one draw per warp, 5
# lanes past it) runs the warp path's shuffles with one class and its
# shared memory with two.
PARITY_CASES = (("fully_connected_8", 64, 2),
                ("fully_connected_8", "waves", 2),
                ("fully_connected_8", "waves", 1),
                ("torus3d_6", 16, 2),
                ("torus3d_6", 16, 1),
                ("fully_connected_64", 16, 1),
                ("fully_connected_16", 64, 2),
                ("torus3d_3", 40, 1),
                ("torus3d_3", 40, 2))
PARITY_IDS = ("fc8", "fc8_waves", "fc8_waves_one_class", "torus3d_6",
              "torus3d_6_one_class", "fc64", "fc16_two_classes",
              "torus3d_3_one_class", "torus3d_3")
# The fused kernel with one ψ of a draw seeded inf: the kernel's vote
# sends that period (and the CTA's or warp's other draws) to the dense
# loop, so the inf / NaN pattern is the plain version's.  torus3d(6) on
# the block path's row lists, FC8 with two classes on the warp path's
# (x in shared memory), torus3d(3) with one class on its shuffles.
NONFINITE_CASES = (("torus3d_6", 16, 1), ("fully_connected_8", 64, 2),
                   ("torus3d_3", 40, 1))
NONFINITE_IDS = ("torus3d_6_block_lists", "fc8_warp_lists",
                 "torus3d_3_warp_shuffles")
NONFINITE_SEED = (3, 5)          # (draw, node) whose ψ starts at +inf


def waves_draws(dev) -> int:
    """FC8 draws that give three draws per CTA and a partial last CTA."""
    import torch
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return 4 * sms * 3 + 5


# Tiled kernel-vs-plain cases of phase 2 and of the card tests:
# (topology, draws, latency classes).  Two classes here means one long
# directed edge 0 → 1, so the stack is not symmetric; three, a 1000 m edge
# 0 → 1 and a 500 m edge 1 → 0.  The ring's edges: torus3d(7) has
# N % 4 != 0 (the 4-byte copies); torus3d(6) has 4 panels, fewer than the
# ring's stages, and with three classes a class boundary falls inside the
# ring; B = 17 gives three draw groups, the last of one draw.  Every case
# runs the guard with bands that trip mid-chunk and that never trip.
TILED_PARITY_CASES = (("torus3d_8", 9, 1), ("torus3d_8", 9, 2),
                      ("torus3d_7", 5, 1), ("torus3d_7", 5, 2),
                      ("torus3d_6", 3, 1), ("torus3d_6", 4, 3),
                      ("torus3d_8", 17, 1))
TILED_PARITY_IDS = ("torus3d_8", "torus3d_8_two_classes", "torus3d_7",
                    "torus3d_7_two_classes", "torus3d_6_few_panels",
                    "torus3d_6_three_classes", "torus3d_8_b17")
TILED_RECORDS, TILED_EVERY = 4, 3
# The fused guard cases: (case, records, record_every, stop caps).  Each
# draw's band trips near a record drawn from 1..records-1, so that draws
# run past the batch's earliest trip and the wrapper replays the chunk.
# FC8 at B=64, and torus3d(8) at B=9 with two classes: N=512 is beyond the
# fused regime, so one CTA of 512 threads per draw reads A from L2.
FUSED_GUARD_CASES = ((("fully_connected_8", 64, 2), 20, 20, (19, 7)),
                     (("torus3d_8", 9, 2), 6, 3, (5, 3)))


# Sparse kernel-vs-plain cases of phase 2 and of the card tests:
# (topology, draws, tables).  FC8 (K = 7); random_regular(300, 3, 0) at
# B = 9 (300 nodes: the last CTA of each draw is partial); the ragged
# bounded_degree_topo(96, 4, 3) with 2 isolated nodes and 2 leaves; the
# same with K + 2 always-padded slots; and per-draw tables in which every
# draw drops its own link (both directions) and has its own latencies —
# all on the direct pass; and torus3d(21) × 235 draws with shared tables
# (8.7 MB of ψ: the grouped pass, 8 draws per thread, the last group of 3).
SPARSE_PARITY_CASES = (("fully_connected_8", 64, "shared"),
                       ("random_regular_300", 9, "shared"),
                       ("bounded_degree_96", 16, "shared"),
                       ("bounded_degree_96", 16, "extra_slots"),
                       ("random_regular_300", 9, "per_draw_dropped"),
                       ("torus3d_21", 235, "shared"))
SPARSE_PARITY_IDS = ("fc8", "random_regular_300", "bounded_degree_96",
                     "bounded_degree_96_k+2", "per_draw_dropped",
                     "torus3d_21_grouped")
SPARSE_RECORDS, SPARSE_EVERY = 6, 5
# Per-step kernel-vs-plain cases of phase 2 and of the card tests: FC8;
# FC8 with the 1000 m spool on the pair (0, 1) (two latency classes); the
# ragged torus3d(7) (343 nodes: the last CTA partial, N % 4 != 0: the
# 4-byte copies) with nodes 0 and N-1 in holdover; torus3d(6) (4 panels,
# fewer than the ring's stages) with one class and with three (a class
# boundary inside the ring).  One draw each, with phase 2's per-draw
# knobs; the guard trips mid-chunk and never.
PERSTEP_PARITY_CASES = ("fc8", "fc8_spool", "torus3d_7", "torus3d_6",
                        "torus3d_6_three_classes")
PERSTEP_RECORDS, PERSTEP_EVERY = 6, 4
# The tiled, sparse and per-step kernels on a diverged draw, each case of
# ``STREAM_NONFINITE_CASES`` with two seeds: "inf", draw 3's ψ at node 5
# (the per-step kernel: node 5 of its one draw) started at +inf; and
# "diverging", draw 3's gain at ``DIVERGING_KP`` (the per-step kernel: its
# one gain), so that the draw runs finite for a record or more and then
# overflows to inf and NaN.  ν, β, ψ, ν', the four watermark arrays and
# the guard's trips must equal the plain version's, inf and NaN at the same
# places.  With a NaN arriving after record 0 a fold that drops NaN (fmaxf
# / fminf) leaves a finite watermark where torch.maximum / minimum keep
# NaN; the "diverging" rows check that their records tell the two apart.
# Sparse: random_regular(300) with shared and with per-draw tables (the
# direct pass) and torus3d(21) × 235 (the grouped pass).
STREAM_NONFINITE_CASES = (
    ("bittide_tiled", ("torus3d_8", 9, 1)),
    ("bittide_tiled", ("torus3d_7", 5, 2)),
    ("bittide_sparse", ("random_regular_300", 9, "shared")),
    ("bittide_sparse", ("random_regular_300", 9, "per_draw_dropped")),
    ("bittide_sparse", ("torus3d_21", 235, "shared")),
    ("bittide_step", "fc8"),
    ("bittide_step", "torus3d_7"))
STREAM_NONFINITE_IDS = ("tiled_torus3d_8", "tiled_torus3d_7_two_classes",
                        "sparse_rr300_direct", "sparse_per_draw_direct",
                        "sparse_torus3d_21_grouped", "perstep_fc8",
                        "perstep_torus3d_7")
DIVERGING_KP = {"bittide_tiled": 1e-2, "bittide_sparse": 1e-4,
                "bittide_step": 1e-3}


def bounded_degree_topo(n, max_deg, seed=0, isolated=0, leaves=0):
    """tests/engine_harness.py's random bounded-in-degree digraph (copied:
    the harness imports jax): node 0 takes max_deg in-edges, the last
    ``isolated`` nodes none, the ``leaves`` before them one."""
    import numpy as np
    from repro_torch.core import Topology
    rng = np.random.default_rng(seed)
    src, dst = [], []
    first_leaf = n - isolated - leaves
    for i in range(n - isolated):
        if i == 0:
            d = max_deg
        elif i >= first_leaf:
            d = 1
        else:
            d = int(rng.integers(1, max_deg + 1))
        others = np.delete(np.arange(n), i)
        picks = rng.choice(others, size=d, replace=False)
        src.extend(int(p) for p in picks)
        dst.extend([i] * d)
    return Topology(n, np.asarray(src, np.int32), np.asarray(dst, np.int32),
                    name=f"bounded_deg_{n}_{max_deg}_{seed}"
                         f"{'_iso' + str(isolated) if isolated else ''}")


def sparse_parity_inputs(case, dev):
    """(topology, sparse kernel args ending in Δ = 125,000 frames,
    per-draw mask) of one of ``SPARSE_PARITY_CASES``: ν_u in ±8 ppm, kp
    = 2e-8 jittered per draw, β_off in ±1, λeff folds of per-edge values
    in ±1 frame (0 at a node without in-edges), holdover on nodes 0 and 1
    for about half the draws, every edge its own latency in 5..60
    frames."""
    import numpy as np
    import torch
    from repro_torch.core import fully_connected, random_regular, torus3d
    from repro_torch.kernels.bittide_sparse import ellify, max_in_degree
    name, b, tables = case
    topo = {"fully_connected_8": lambda: fully_connected(8),
            "random_regular_300": lambda: random_regular(300, 3, 0),
            "torus3d_21": lambda: torus3d(21),
            "bounded_degree_96": lambda: bounded_degree_topo(
                96, 4, 3, isolated=2, leaves=2)}[name]()
    n, e = topo.num_nodes, topo.num_edges
    rng = np.random.default_rng(4)
    per_draw = tables == "per_draw_dropped"
    lat_f = rng.uniform(5.0, 60.0, (b, e) if per_draw else e)
    edge_w = None
    if per_draw:
        rev = topo.reverse_edge_index()
        edge_w = np.ones((b, e))
        for d, pick in enumerate(rng.integers(0, e, b)):
            edge_w[d, [pick, rev[pick]]] = 0.0
    max_deg = max_in_degree(topo) + (2 if tables == "extra_slots" else 0)
    nbr, latf, w = ellify(topo, lat_f, edge_w=edge_w, max_deg=max_deg)
    put = lambda x: torch.as_tensor(np.array(x, np.float32), device=dev)
    nu_u = put(rng.uniform(-8, 8, (b, n)) * 1e-6)
    mask = np.ones((b, n), np.float32)
    mask[:, :2] = np.where(rng.random((b, 1)) < 0.5, 0.0, 1.0)
    lamsum = (w * rng.uniform(-1, 1, (b,) + w.shape[1:])).sum(axis=1)
    args = (torch.zeros_like(nu_u), nu_u.clone(), nu_u,
            torch.as_tensor(nbr, device=dev), put(latf), put(w),
            put(lamsum),
            put(2e-8 * rng.uniform(0.5, 1.5, b)), put(rng.uniform(-1, 1, b)),
            125000.0)
    return topo, args, put(mask)


def sparse_variants(args, kw, b):
    """The four variants, then the guard with bands that trip draw i near
    record 1 + i % 3 and with bands that never trip."""
    import torch
    from repro_torch.kernels.bittide_sparse import bittide_sparse_torch
    base = bittide_sparse_torch(*args, **dict(kw, record_beta=True))
    deg = args[5].sum(dim=1).clamp(min=1.0)
    peak = (base.beta.abs() / deg).amax(dim=2)                 # (R, B)
    out = [dict(record_beta=beta, record_watermarks=wm)
           for beta, wm in ((False, False), (True, False), (False, True),
                            (True, True))]
    for trips in (True, False):
        band = torch.stack([peak[1 + i % 3, i] * 0.999 if trips
                            else 10 * peak.max() for i in range(b)])
        out.append(dict(record_beta=True, record_watermarks=True,
                        record_guard=True, guard_lo=(-band).contiguous(),
                        guard_hi=band.contiguous(),
                        guard_stop=kw["num_records"] - 1))
    return out


def one_way_links(topo):
    """2 m cables, plus 1000 m on the single directed edge 0 → 1."""
    import numpy as np
    from repro_torch.core import make_links
    cable = np.full(topo.num_edges, 2.0)
    cable[(topo.src == 0) & (topo.dst == 1)] = 1000.0
    return make_links(topo, cable_m=cable)


def three_class_links(topo):
    """2 m cables, 1000 m on the directed edge 0 → 1 and 500 m on 1 → 0:
    three latency classes."""
    import numpy as np
    from repro_torch.core import make_links
    cable = np.full(topo.num_edges, 2.0)
    cable[(topo.src == 0) & (topo.dst == 1)] = 1000.0
    cable[(topo.src == 1) & (topo.dst == 0)] = 500.0
    return make_links(topo, cable_m=cable)


def parity_inputs(case, dev, one_way=False):
    """(topology, kernel args ending in Δ = 125,000 frames, per-draw mask)
    of one of ``PARITY_CASES`` / ``TILED_PARITY_CASES``."""
    import numpy as np
    from repro_torch.core import fully_connected, make_links, torus3d
    name, b, classes = case
    topo = {"fully_connected_8": lambda: fully_connected(8),
            "fully_connected_16": lambda: fully_connected(16),
            "fully_connected_64": lambda: fully_connected(64),
            "torus3d_3": lambda: torus3d(3),
            "torus3d_6": lambda: torus3d(6), "torus3d_7": lambda: torus3d(7),
            "torus3d_8": lambda: torus3d(8)}[name]()
    b = waves_draws(dev) if b == "waves" else b
    links = {1: lambda: make_links(topo, cable_m=2.0),
             2: lambda: (one_way_links(topo) if one_way
                         else two_class_links(topo)),
             3: lambda: three_class_links(topo)}[classes]()
    ppm = np.random.default_rng(1).uniform(-8, 8, (b, topo.num_nodes))
    args, mask = fused_inputs(topo, links, ppm, 2e-8, dev, seed=2)
    assert args[3].shape[0] == classes, args[3].shape
    return topo, args + (125000.0,), mask


def kernel_vs_plain(got, want, records=None, exact=False) -> dict:
    """The kernel's errors against the plain version's outputs over the
    first ``records`` records (all by default; a guard freeze leaves the
    later ones unrun); raises when one leaves its bar (ν at
    FREQ_ATOL_PPM, β and max |β| at BETA_ATOL_FRAMES, watermark and trip
    indices exactly; with ``exact`` every error must be 0.0)."""
    import torch
    r = slice(None) if records is None else slice(0, records)
    err = dict(freq_err_ppm=float(
        (got.freq[r] - want.freq[r]).abs().max() * 1e6),
        psi_err_frames=float((got.psi - want.psi).abs().max()))
    if got.beta is not None:
        err["beta_err_frames"] = float(
            (got.beta[r] - want.beta[r]).abs().max())
    if got.watermarks is not None:
        err["peak_record_equal"] = bool(torch.equal(got.watermarks[1],
                                                    want.watermarks[1]))
        err["beta_abs_max_err_frames"] = float(
            (got.watermarks[0] - want.watermarks[0]).abs().max())
    if got.guard_state is not None:
        err["trip_equal"] = bool(torch.equal(got.guard_state,
                                             want.guard_state))
        assert err["trip_equal"], err
    assert err["freq_err_ppm"] <= FREQ_ATOL_PPM, err
    assert err.get("beta_err_frames", 0.0) <= BETA_ATOL_FRAMES, err
    assert err.get("beta_abs_max_err_frames", 0.0) <= BETA_ATOL_FRAMES, err
    assert err.get("peak_record_equal", True), err
    if exact:
        assert all(v == 0.0 for k, v in err.items() if k.endswith(
            ("_ppm", "_frames"))), err
    return err


def fused_inputs(topo, links, ppm, kp, dev, seed=None):
    """The fused kernel's arguments for a cold start.

    With ``seed`` the scenario knobs vary per draw (kp jitter, class
    latencies ±1 %, λeff folds in ±2 frames, setpoints in ±1 frame,
    holdover on nodes 0 and 1 for about half the draws); without it the
    arguments are those ``simulate_ensemble_dense`` builds.
    """
    import numpy as np
    import torch
    from repro_torch.kernels import densify
    a_t, _, classes, _ = densify(topo, links, device=dev)
    b, n = ppm.shape
    c = a_t.shape[0]
    put = lambda x: torch.as_tensor(np.array(x, np.float32), device=dev)
    nu_u = put(ppm.astype(np.float32) * np.float32(1e-6))
    lat = np.broadcast_to(classes.cpu().numpy(), (b, c))
    kp_v = np.full(b, kp, np.float32)
    boff = np.zeros(b, np.float32)
    lamsum = np.zeros((b, n), np.float32)
    mask = np.ones((1, n), np.float32)
    if seed is not None:
        rng = np.random.default_rng(seed)
        lat = lat * rng.uniform(0.99, 1.01, (b, 1))
        kp_v = kp * rng.uniform(0.5, 1.5, b)
        boff = rng.uniform(-1, 1, b)
        lamsum = rng.uniform(-2, 2, (b, n))
        mask = np.ones((b, n), np.float32)
        mask[:, :2] = np.where(rng.random((b, 1)) < 0.5, 0.0, 1.0)
    args = (torch.zeros_like(nu_u), nu_u, nu_u.clone(), a_t,
            a_t.sum(dim=(0, 1)), put(lamsum), put(lat), put(kp_v), put(boff))
    return args, put(mask)


def bound(b, n, c, nnz, steps, records, beta, wm):
    """(bound_ms, bound_by) for one call of a dense kernel.

    Bytes: every input read once, every output written once.  Operations:
    what this run's data needs — 2 per nonzero of the stack per period
    plus the per-node update (x_c: 2C, err/ν'/ψ': 10), and at records
    with β or watermarks the row mean (N + 1 per draw) and the measure
    pass (2 per nonzero + 3C per node + 4).
    """
    nodes = b * n
    in_bytes = 4 * (4 * nodes + c * n * n + n + b * c + 2 * b + n)
    out_bytes = 4 * (2 * nodes + records * nodes * (1 + beta) + 4 * wm * nodes)
    ops = b * steps * (2 * nnz + n * (2 * c + 10))
    if beta or wm:
        ops += b * records * (n + 1 + 2 * nnz + n * (3 * c + 4))
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_sm_clock_mhz() -> float:
    """The card's highest SM clock, MHz (``nvidia-smi``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def sync_cycles(plan, c) -> float:
    """The measured cycles of one period's synchronisation round under a
    fused launch plan (SYNC_CYCLES, BLOCK_SYNC_CYCLES)."""
    if plan["path"] == "warp":
        return SYNC_CYCLES["shfl" if c == 1 and plan["registers"]
                           else "warp"]
    # A block path CTA holds at least 33 threads: two warps, as 64.
    width = 32 * -(-plan["threads"] // 32)
    return BLOCK_SYNC_CYCLES[max(t for t in BLOCK_SYNC_CYCLES
                                 if t <= max(width, 64))]


def fused_latency_bound(row_terms, c, n, steps, records, measure, sync,
                        clock_mhz):
    """(latency_bound_ms, cycles per period) of one fused-kernel call: the
    periods run one after another, so the call takes at least, per period,
    the longest row's chain of ``row_terms`` dependent adds plus one add
    per class, the update's UPDATE_CHAIN_OPS dependent operations (each
    FP32_DEP_CYCLES) and one synchronisation round (``sync`` cycles,
    :func:`sync_cycles`), and per record with a measure pass the row
    mean's chain of N adds, at the card's highest SM clock."""
    period = (FP32_DEP_CYCLES * (row_terms + c + UPDATE_CHAIN_OPS)
              + sync)
    cycles = steps * period + (records * FP32_DEP_CYCLES * n if measure
                               else 0)
    return cycles / (clock_mhz * 1e3), period


def float32_floor_ppm(kp, deg_max, psi_max):
    """Float32 floor between two implementations of the period loop, ppm.

    The fused lane forms err = Σ_j A_ij (ψ_j − ν_j·lat) − ψ_i·deg_i + …,
    sums of size deg·|ψ| that cancel to O(1) frames, where the segment-sum
    lane sums the per-edge β directly; and two implementations that round
    ψ + ν·Δ differently (a fused multiply-add or not) hold ψ apart by ulps
    of |ψ|.  Each of the deg + 2 roundings at that size is at most an ulp
    of deg·max|ψ|, and ν follows err through kp.
    """
    import numpy as np
    return float(kp * (deg_max + 2)
                 * np.spacing(np.float32(deg_max * psi_max)) * 1e6)


def summary(freq_ppm, times):
    import numpy as np
    from repro_torch.core.frame_model import _convergence_time
    band = freq_ppm[:, -1].max(axis=1) - freq_ppm[:, -1].min(axis=1)
    spread = freq_ppm.max(axis=2) - freq_ppm.min(axis=2)
    conv = np.array([_convergence_time(s, times, 1.0) for s in spread])
    return dict(final_band_ppm_max=float(band.max()),
                final_band_ppm_p50=float(np.median(band)),
                convergence_s_p50=float(np.percentile(conv, 50)),
                convergence_s_p95=float(np.percentile(conv, 95)),
                converged_draws=int(np.isfinite(conv).sum()))


def trip_bands(args, kw, recs):
    """(B,) guard band half-widths (frames per unit degree) that trip draw
    b near record ``recs[b]`` of the guard-off plain run, or never where
    ``recs[b]`` is None."""
    import torch
    from repro_torch.kernels.bittide_step import bittide_fused_torch
    base = bittide_fused_torch(*args, **dict(kw, record_beta=True,
                                             record_watermarks=False))
    deg = args[4].clamp(min=1.0)
    peak = (base.beta.abs() / deg).amax(dim=2)               # (R, B)
    return torch.stack([peak[r, i] * 0.999 if r is not None
                        else 10 * peak.max()
                        for i, r in enumerate(recs)]).contiguous()


def fused_plan_of(args, dev, guard=False) -> dict:
    """The fused kernel's launch plan for these kernel arguments, as the
    wrapper computes it (the stack's row lists counted)."""
    from repro_torch.kernels.bittide_step import launch_plan, row_lists
    b, n = args[0].shape
    return launch_plan(b, n, args[3].shape[0], dev,
                       row_lists(args[3])[1].shape[0], guard=guard)


def nonfinite_vs_plain(got, want, records=None) -> dict:
    """The kernel against the plain version where values may be inf or
    NaN: every value bit for bit, inf and NaN at the same positions (infs
    of the same sign); raises otherwise.  Returns the count of non-finite
    values and the largest error over the finite ones (0.0)."""
    import torch
    r = slice(None) if records is None else slice(0, records)
    pairs = [(got.freq[r], want.freq[r]), (got.psi, want.psi),
             (got.nu, want.nu)]
    if got.beta is not None:
        pairs.append((got.beta[r], want.beta[r]))
    if got.watermarks is not None:
        assert torch.equal(got.watermarks[1], want.watermarks[1])
        pairs += [(got.watermarks[k], want.watermarks[k]) for k in (0, 2, 3)]
    if got.guard_state is not None:
        assert torch.equal(got.guard_state, want.guard_state)
    bad = 0
    for g, w in pairs:
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        bad += int((~torch.isfinite(w)).sum())
    return dict(nonfinite_values=bad, nonfinite_positions_equal=True,
                freq_err_ppm=0.0, beta_err_frames=0.0)


def fused_nonfinite_rows(case, dev):
    """One of ``NONFINITE_CASES`` with draw 3's ψ at node 5 started at
    +inf: ν, β, ψ, ν', the watermarks (NaN kept by the running max and
    min, as torch.maximum / minimum keep it) and the guard (bands that
    trip the finite draws at different records) against the plain
    version, bit for bit with identical inf / NaN positions, by the plan
    Python computed; the seeded draw goes non-finite and every other draw
    stays finite.  Returns one row per variant."""
    import torch
    from repro_torch.kernels.bittide_step import (bittide_fused,
                                                  bittide_fused_torch,
                                                  fused_device_plan)
    d, i = NONFINITE_SEED
    topo, args, mask = parity_inputs(case, dev)
    b = args[0].shape[0]
    kw = dict(num_records=6, record_every=5, ctrl_mask=mask)
    band = trip_bands(args, kw, [1 + k % 3 for k in range(b)])
    psi = args[0].clone()
    psi[d, i] = float("inf")
    seeded = (psi,) + args[1:]
    rows = []
    for v in (dict(), dict(record_beta=True), dict(record_watermarks=True),
              dict(record_beta=True, record_watermarks=True,
                   record_guard=True, guard_lo=-band, guard_hi=band,
                   guard_stop=5)):
        plan = fused_plan_of(seeded, dev, guard="record_guard" in v)
        assert plan["aggregation"] == "lists", plan
        got = bittide_fused(*seeded, **kw, **v)
        torch.cuda.synchronize()
        assert fused_device_plan() == plan, (fused_device_plan(), plan)
        want = bittide_fused_torch(*seeded, **kw, **v)
        records = None
        if v.get("record_guard"):
            records = int(want.guard_state.min()) + 1
        row = dict(phase="parity", kernel="bittide_fused",
                   nonfinite_seed=[d, i], topology=topo.name, draws=b,
                   classes=args[3].shape[0],
                   beta=v.get("record_beta", False),
                   watermarks=v.get("record_watermarks", False),
                   guard=v.get("record_guard", False), launch_plan=plan)
        row.update(nonfinite_vs_plain(got, want, records))
        fin = torch.isfinite(got.freq[:records]).all(dim=2).all(dim=0)
        row["seeded_draw_nonfinite"] = not bool(fin[d])
        row["other_draws_finite"] = bool(
            fin[torch.arange(b, device=fin.device) != d].all())
        assert row["seeded_draw_nonfinite"] and \
            row["other_draws_finite"], row
        rows.append(row)
    return rows


def phase_parity(dev):
    """Each kernel vs its plain version on the card; returns the max
    errors per kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels.bittide_step import (bittide_fused,
                                                  bittide_fused_torch,
                                                  fused_device_plan)
    worst = {k: dict(freq_ppm=0.0, beta_frames=0.0)
             for k in ("bittide_fused", "bittide_tiled", "bittide_sparse",
                       "bittide_step")}

    def note(kernel, row):
        emit(row)
        w = worst[kernel]
        w["freq_ppm"] = max(w["freq_ppm"], row["freq_err_ppm"])
        w["beta_frames"] = max(w["beta_frames"],
                               row.get("beta_err_frames", 0.0))

    plans = []
    for case in PARITY_CASES:
        topo, args, mask = parity_inputs(case, dev)
        b, n = args[0].shape
        plan = fused_plan_of(args, dev)
        plans.append((plan, b))
        for beta, wm in ((False, False), (True, False), (False, True),
                         (True, True)):
            kw = dict(num_records=20, record_every=20, ctrl_mask=mask,
                      record_beta=beta, record_watermarks=wm)
            got = bittide_fused(*args, **kw)
            torch.cuda.synchronize()
            # The library launched the plan Python computed.
            assert fused_device_plan() == plan, (fused_device_plan(), plan)
            want = bittide_fused_torch(*args, **kw)
            row = dict(phase="parity", kernel="bittide_fused",
                       topology=topo.name, draws=b,
                       classes=args[3].shape[0], beta=beta, watermarks=wm,
                       launch_plan=plan)
            row.update(kernel_vs_plain(got, want, exact=True))
            note("bittide_fused", row)
    # The cases reach both paths with both aggregations, rows in registers
    # and not on each path, the stack in shared memory and in device
    # memory, and several draws per CTA with a partial last CTA.
    assert {(p["path"], p["aggregation"]) for p, _ in plans} == {
        ("warp", "lists"), ("warp", "dense"), ("block", "lists"),
        ("block", "dense")}, plans
    assert {(p["path"], p["registers"]) for p, _ in plans} == {
        ("warp", True), ("warp", False), ("block", True),
        ("block", False)}, plans
    assert {p["a_in_smem"] for p, _ in plans} == {True, False}, plans
    assert any(p["draws_per_cta"] > 1 and b % p["draws_per_cta"]
               for p, b in plans), plans
    for case in NONFINITE_CASES:
        for row in fused_nonfinite_rows(case, dev):
            note("bittide_fused", row)

    # The fused guard: draws trip at different records, so the wrapper
    # launches the chunk twice (the second time capped at the earliest
    # trip).
    for case, records, every, stops in FUSED_GUARD_CASES:
        topo, args, mask = parity_inputs(case, dev)
        b, n = args[0].shape
        kw = dict(num_records=records, record_every=every, ctrl_mask=mask)
        recs = np.random.default_rng(5).integers(1, records, b).tolist()
        band = trip_bands(args, kw, recs)
        for stop in stops:
            gkw = dict(kw, record_beta=True, record_watermarks=True,
                       record_guard=True, guard_lo=-band, guard_hi=band,
                       guard_stop=stop)
            before = bittide_fused.launches
            got = bittide_fused(*args, **gkw)
            torch.cuda.synchronize()
            launches = bittide_fused.launches - before
            want = bittide_fused_torch(*args, **gkw)
            trips = want.guard_state[:, 0]
            valid = min(int(trips.min()), stop) + 1
            row = dict(phase="parity", kernel="bittide_fused", guard=True,
                       topology=topo.name, draws=b,
                       classes=args[3].shape[0], stop=stop,
                       earliest_trip=int(trips.min()),
                       tripped_draws=int((trips == trips.min()).sum()),
                       launches=launches, valid_records=valid,
                       launch_plan=fused_plan_of(args, dev, guard=True))
            row.update(kernel_vs_plain(got, want, records=valid,
                                       exact=True))
            # Draws ran past the earliest trip, so the chunk was replayed.
            assert launches == 2 and row["earliest_trip"] < stop, row
            note("bittide_fused", row)

    tiled_parity(dev, note)
    sparse_parity(dev, note)
    perstep_parity(dev, note)
    for kernel, case in STREAM_NONFINITE_CASES:
        for seed in ("inf", "diverging"):
            for row in stream_nonfinite_rows(kernel, case, seed, dev):
                note(kernel, row)
    return worst


def tiled_parity(dev, note):
    """Phase 2's tiled cases: every variant of every case of
    ``TILED_PARITY_CASES`` against the plain version at 0.0 error, each
    row passed to ``note``; the guard trips mid-chunk and never."""
    import torch
    from repro_torch.kernels.bittide_step import (bittide_fused_torch,
                                                  bittide_tiled,
                                                  tiled_launch_plan)
    for case in TILED_PARITY_CASES:
        topo, args, mask = parity_inputs(case, dev, one_way=True)
        b, n = args[0].shape
        kw = dict(num_records=TILED_RECORDS, record_every=TILED_EVERY,
                  ctrl_mask=mask)
        variants = [dict(record_beta=beta, record_watermarks=wm)
                    for beta, wm in ((False, False), (True, False),
                                     (False, True), (True, True))]
        for trips in (True, False):
            recs = [1 + i % 3 if trips else None for i in range(b)]
            band = trip_bands(args, kw, recs)
            variants.append(dict(record_beta=True, record_watermarks=True,
                                 record_guard=True, guard_lo=-band,
                                 guard_hi=band,
                                 guard_stop=TILED_RECORDS - 1))
        trip_rows = []
        for v in variants:
            before = bittide_tiled.launches
            got = bittide_tiled(*args, **kw, **v)
            torch.cuda.synchronize()
            assert bittide_tiled.launches == before + 1
            want = bittide_fused_torch(*args, **kw, **v)
            valid = TILED_RECORDS
            row = dict(phase="parity", kernel="bittide_tiled",
                       topology=topo.name, draws=b,
                       classes=args[3].shape[0], beta=v["record_beta"],
                       watermarks=v["record_watermarks"],
                       guard=v.get("record_guard", False),
                       launch_plan=tiled_launch_plan(b, n, args[3].shape[0]))
            if row["guard"]:
                valid = min(int(want.guard_state.min()), TILED_RECORDS) + 1
                row["earliest_trip"] = int(want.guard_state.min())
                trip_rows.append(row["earliest_trip"])
            row.update(kernel_vs_plain(got, want, records=valid, exact=True))
            note("bittide_tiled", row)
        # One band set trips inside the chunk, the other never.
        assert trip_rows[0] < TILED_RECORDS - 1 and \
            trip_rows[1] == TILED_RECORDS, trip_rows


def sparse_parity(dev, note):
    """Phase 2's sparse cases: every variant of every case of
    ``SPARSE_PARITY_CASES`` against the plain version at 0.0 error, each
    row passed to ``note``."""
    import torch
    from repro_torch.kernels.bittide_sparse import (bittide_sparse,
                                                    bittide_sparse_torch)
    from repro_torch.kernels.bittide_step import (sparse_device_plan,
                                                  sparse_launch_plan)
    grouped = set()
    for case in SPARSE_PARITY_CASES:
        topo, args, mask = sparse_parity_inputs(case, dev)
        b, n = args[0].shape
        kw = dict(num_records=SPARSE_RECORDS, record_every=SPARSE_EVERY,
                  ctrl_mask=mask)
        plan = sparse_launch_plan(b, n, int(args[3].shape[0]),
                                  args[4].shape[0] == args[5].shape[0] == 1)
        grouped.add(plan["grouped"])
        trip_rows = []
        for v in sparse_variants(args, kw, b):
            before = bittide_sparse.launches
            got = bittide_sparse(*args, **kw, **v)
            torch.cuda.synchronize()
            assert bittide_sparse.launches == before + 1
            # The library ran the plan Python computed.
            assert sparse_device_plan() == plan, (sparse_device_plan(), plan)
            want = bittide_sparse_torch(*args, **kw, **v)
            valid = SPARSE_RECORDS
            row = dict(phase="parity", kernel="bittide_sparse",
                       topology=topo.name, draws=b, tables=case[2],
                       k=int(args[3].shape[0]),
                       table_rows=int(args[4].shape[0]),
                       beta=v["record_beta"],
                       watermarks=v["record_watermarks"],
                       guard=v.get("record_guard", False),
                       launch_plan=plan)
            if row["guard"]:
                row["earliest_trip"] = int(want.guard_state.min())
                valid = min(row["earliest_trip"], SPARSE_RECORDS - 1) + 1
                trip_rows.append(row["earliest_trip"])
                row["frozen_records_nan"] = bool(
                    torch.isnan(got.freq[valid:]).all())
                assert row["frozen_records_nan"], row
            row.update(kernel_vs_plain(got, want, records=valid, exact=True))
            note("bittide_sparse", row)
        assert trip_rows[0] < SPARSE_RECORDS - 1 and \
            trip_rows[1] == SPARSE_RECORDS, trip_rows
    assert grouped == {True, False}, grouped


def perstep_inputs(case, dev):
    """(topology, per-step kernel args ending in Δ = 125,000 frames,
    (N,) mask) of one of ``PERSTEP_PARITY_CASES``: draw 0 of
    ``parity_inputs``'s per-draw knobs (kp, class latencies, λeff fold,
    setpoint), ψ started in ±5 frames."""
    import numpy as np
    import torch
    name, classes = {"fc8": ("fully_connected_8", 1),
                     "fc8_spool": ("fully_connected_8", 2),
                     "torus3d_7": ("torus3d_7", 1),
                     "torus3d_6": ("torus3d_6", 1),
                     "torus3d_6_three_classes": ("torus3d_6", 3)}[case]
    topo, args, _ = parity_inputs((name, 1, classes), dev)
    n = topo.num_nodes
    psi = torch.as_tensor(np.random.default_rng(3).uniform(-5, 5, n),
                          dtype=torch.float32, device=dev)
    mask = torch.ones(n, device=dev)
    if case == "torus3d_7":
        mask[[0, n - 1]] = 0.0
    row = lambda x: x[0].contiguous()
    return topo, (psi, row(args[1]), row(args[2]), args[3], args[4],
                  row(args[5]), row(args[6]), float(args[7][0]),
                  float(args[8][0]), args[9]), mask


def perstep_variants(args, kw):
    """The four variants, then the guard with a band that trips near
    record 2 and with one that never trips."""
    from repro_torch.kernels.bittide_step import bittide_perstep_torch
    base = bittide_perstep_torch(*args, **dict(kw, record_beta=True))
    peak = (base.beta.abs() / args[4].clamp(min=1.0)).amax(dim=1)  # (R,)
    out = [dict(record_beta=beta, record_watermarks=wm)
           for beta, wm in ((False, False), (True, False), (False, True),
                            (True, True))]
    for band in (float(peak[2]) * 0.999, 10 * float(peak.max())):
        out.append(dict(record_beta=True, record_watermarks=True,
                        record_guard=True, guard_lo=-band, guard_hi=band,
                        guard_stop=kw["num_records"] - 1))
    return out


def perstep_parity(dev, note):
    """Phase 2's per-step cases: every variant of every case of
    ``PERSTEP_PARITY_CASES`` against the plain version at 0.0 error, each
    row passed to ``note``; the guard trips at a mid record and never."""
    import torch
    from repro_torch.kernels.bittide_step import (bittide_perstep,
                                                  bittide_perstep_torch)
    for case in PERSTEP_PARITY_CASES:
        topo, args, mask = perstep_inputs(case, dev)
        kw = dict(num_records=PERSTEP_RECORDS, record_every=PERSTEP_EVERY,
                  ctrl_mask=mask)
        trips = []
        for v in perstep_variants(args, kw):
            before = bittide_perstep.launches
            got = bittide_perstep(*args, **kw, **v)
            torch.cuda.synchronize()
            launched = bittide_perstep.launches - before
            measure = v["record_beta"] or v["record_watermarks"]
            assert launched == PERSTEP_RECORDS * (
                PERSTEP_EVERY + 2 * measure), launched
            want = bittide_perstep_torch(*args, **kw, **v)
            row = dict(phase="parity", kernel="bittide_step", case=case,
                       topology=topo.name, classes=int(args[3].shape[0]),
                       beta=v["record_beta"],
                       watermarks=v["record_watermarks"],
                       guard=v.get("record_guard", False),
                       launches=launched)
            if row["guard"]:
                row["trip"] = int(want.guard_state)
                trips.append(row["trip"])
            row.update(kernel_vs_plain(got, want, exact=True))
            note("bittide_step", row)
        assert trips[0] < PERSTEP_RECORDS - 1 and \
            trips[1] == PERSTEP_RECORDS, trips


def nan_fold_differs(out) -> bool:
    """Whether folding ``out``'s β and ν records with fmax / fmin (which
    drop NaN, as CUDA's fmaxf / fminf do) gives other watermarks than
    torch.maximum / minimum: True when a NaN first arrives after record 0
    at a place whose running value was not NaN."""
    import torch
    beta, freq = out.beta, out.freq

    def fold(mx, mn):
        acc = [beta[0].abs(), freq[0], freq[0]]
        for t in range(1, beta.shape[0]):
            acc = [mx(acc[0], beta[t].abs()), mn(acc[1], freq[t]),
                   mx(acc[2], freq[t])]
        return acc
    keep = fold(torch.maximum, torch.minimum)
    drop = fold(torch.fmax, torch.fmin)
    return any(not torch.equal(torch.isnan(k), torch.isnan(d))
               for k, d in zip(keep, drop))


def stream_nonfinite_inputs(kernel, case, seed, dev):
    """The inputs of one case of ``STREAM_NONFINITE_CASES`` with ``seed``
    "inf" or "diverging": (topology, seeded kernel args, kw, the guard
    variant — bands from the unseeded run that trip the finite draws at
    different records —, the kernel, its plain version, the sparse
    kernel's plan or None)."""
    from repro_torch.kernels.bittide_sparse import (bittide_sparse,
                                                    bittide_sparse_torch)
    from repro_torch.kernels.bittide_step import (bittide_fused_torch,
                                                  bittide_perstep,
                                                  bittide_perstep_torch,
                                                  bittide_tiled,
                                                  sparse_launch_plan)
    d, i = NONFINITE_SEED
    plan = None
    if kernel == "bittide_tiled":
        topo, args, mask = parity_inputs(case, dev, one_way=True)
        kw = dict(num_records=TILED_RECORDS, record_every=TILED_EVERY,
                  ctrl_mask=mask)
        b = args[0].shape[0]
        band = trip_bands(args, kw, [1 + k % 3 for k in range(b)])
        trip = dict(record_beta=True, record_watermarks=True,
                    record_guard=True, guard_lo=-band, guard_hi=band,
                    guard_stop=TILED_RECORDS - 1)
        fn, plain = bittide_tiled, bittide_fused_torch
    elif kernel == "bittide_sparse":
        topo, args, mask = sparse_parity_inputs(case, dev)
        kw = dict(num_records=SPARSE_RECORDS, record_every=SPARSE_EVERY,
                  ctrl_mask=mask)
        b = args[0].shape[0]
        trip = sparse_variants(args, kw, b)[4]
        plan = sparse_launch_plan(b, topo.num_nodes, int(args[3].shape[0]),
                                  args[4].shape[0] == args[5].shape[0] == 1)
        fn, plain = bittide_sparse, bittide_sparse_torch
    else:
        topo, args, mask = perstep_inputs(case, dev)
        kw = dict(num_records=PERSTEP_RECORDS, record_every=PERSTEP_EVERY,
                  ctrl_mask=mask)
        trip = perstep_variants(args, kw)[4]
        fn, plain = bittide_perstep, bittide_perstep_torch
    seeded = list(args)
    if seed == "inf":
        psi = args[0].clone()
        psi[(d, i) if psi.dim() == 2 else i] = float("inf")
        seeded[0] = psi
    elif kernel == "bittide_step":
        seeded[7] = DIVERGING_KP[kernel]
    else:
        kp = args[7].clone()
        kp[d] = DIVERGING_KP[kernel]
        seeded[7] = kp
    return topo, seeded, kw, trip, fn, plain, plan


def stream_nonfinite_rows(kernel, case, seed, dev):
    """One case of ``STREAM_NONFINITE_CASES`` with ``seed`` "inf" or
    "diverging": every variant (the four and the guard tripping the finite
    draws at different records) against the plain version, bit for bit
    with identical inf / NaN positions, the sparse kernel by the plan
    Python computed.  The seeded draw goes non-finite (the guard variant
    aside: a diverging draw may trip first) and every other draw stays
    finite; a "diverging" row's records tell a NaN-dropping fold from the
    plain version's.  Returns one row per variant."""
    import torch
    from repro_torch.kernels.bittide_step import sparse_device_plan
    d, i = NONFINITE_SEED
    topo, seeded, kw, trip, fn, plain, plan = stream_nonfinite_inputs(
        kernel, case, seed, dev)
    b = 1 if seeded[0].dim() == 1 else seeded[0].shape[0]
    rows = []
    for v in [dict(record_beta=beta, record_watermarks=wm)
              for beta, wm in ((False, False), (True, False), (False, True),
                               (True, True))] + [trip]:
        got = fn(*seeded, **kw, **v)
        torch.cuda.synchronize()
        if plan is not None:
            assert sparse_device_plan() == plan, (sparse_device_plan(), plan)
        want = plain(*seeded, **kw, **v)
        records = None
        guard = v.get("record_guard", False)
        if guard:
            records = min(int(want.guard_state.min()), v["guard_stop"]) + 1
        row = dict(phase="parity", kernel=kernel, nonfinite_seed=seed,
                   seeded=[d, i] if b > 1 else [i], topology=topo.name,
                   draws=b, beta=v["record_beta"],
                   watermarks=v["record_watermarks"], guard=guard)
        if plan is not None:
            row["launch_plan"] = plan
        row.update(nonfinite_vs_plain(got, want, records))
        fin = torch.isfinite(got.freq[:records])
        if b == 1:
            row["seeded_draw_nonfinite"] = not bool(fin.all())
            row["other_draws_finite"] = True
        else:
            fin = fin.all(dim=2).all(dim=0)
            row["seeded_draw_nonfinite"] = not bool(fin[d])
            row["other_draws_finite"] = bool(
                fin[torch.arange(b, device=fin.device) != d].all())
        assert row["other_draws_finite"], row
        assert guard or row["seeded_draw_nonfinite"], row
        if v["record_beta"] and v["record_watermarks"] and not guard:
            row["nan_dropping_fold_differs"] = nan_fold_differs(want)
            assert seed == "inf" or row["nan_dropping_fold_differs"], row
        rows.append(row)
    return rows


def timed(fn):
    """(result, host seconds) of ``fn()``, synchronized with the card."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def host_split(topo, links, out, tel, dev, reps: int = 3) -> dict:
    """The host side of one ``simulate_ensemble_dense`` call, timed piece
    by piece as that call does it (median of ``reps``): the stack's
    scatter on the host, its copy to the card, and the copies of the
    records and state back."""
    import numpy as np
    import torch
    from repro_torch.core.frame_model import OMEGA_NOM
    from repro_torch.kernels.ops import _scatter, latency_classes
    classes, inv = latency_classes(
        np.asarray(links.latency_s, np.float64) * OMEGA_NOM)
    scatter = lambda: _scatter(topo, inv, len(classes),
                               np.ones(topo.num_edges))
    stack = scatter()
    rec = lambda x: x.transpose(0, 1).contiguous().cpu().numpy()

    def back():
        rec(out.freq * 1e6)
        out.psi.cpu(), out.nu.cpu()
        if tel.beta:
            rec(out.beta)
        if tel.watermarks:
            [w.cpu() for w in out.watermarks]
    median = lambda fn: float(np.median([timed(fn)[1] for _ in range(reps)]))
    return dict(host_stack_scatter_s=median(scatter),
                stack_to_card_s=median(
                    lambda: torch.as_tensor(stack, device=dev)),
                records_to_host_s=median(back))


def run_main_path(name, topo, b, kp, dt, steps, rec, tel, dev, engine,
                  subset, reps, plain_depth=None):
    """One main-path run of a dense lane plus its measurements.

    ``simulate_ensemble_dense`` runs with the kernel's count set to 0 just
    before and read just after.  Then the segment-sum lane on ``subset``
    draws; the kernel's CUDA-event time over ``reps`` launches on the main
    path's inputs; one more launch that must reproduce the main path's
    records bit for bit; the call's wall again (median of 3) beside its
    host side (``host_split``); and the plain version on the same inputs
    over every draw — at the main path's depth, or over ``plain_depth`` =
    (records, record_every) with the kernel timed on the same work.
    """
    import numpy as np
    import torch
    from repro_torch.core import (ControllerConfig, SimConfig, make_links,
                                  simulate_ensemble)
    from repro_torch.kernels import simulate_ensemble_dense
    from repro_torch.kernels.bittide_step import (bittide_fused,
                                                  bittide_fused_torch,
                                                  bittide_tiled,
                                                  fused_device_plan,
                                                  row_lists,
                                                  tiled_launch_plan)
    from repro_torch.telemetry import Watermarks
    kernel = {"fused": bittide_fused, "tiled": bittide_tiled}[engine]
    n = topo.num_nodes
    links = make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(0).uniform(-8, 8, (b, n))
    records = steps // rec

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.launches = 0
    t0 = time.perf_counter()
    res = simulate_ensemble_dense(topo, links, ppm, steps, kp, dt=dt,
                                  record_every=rec, telemetry=tel)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches
    mem = torch.cuda.max_memory_allocated()
    assert launches >= 1, f"{name}: the main path launched no {engine} kernel"

    freq, psi = res
    assert res.engine == engine, res.engine
    assert freq.shape == (b, records, n), freq.shape
    assert np.isfinite(freq).all() and np.isfinite(psi).all()
    if tel.beta:
        assert res.beta.shape == freq.shape and np.isfinite(res.beta).all()
    if tel.watermarks:
        assert np.isfinite(res.watermarks.beta_abs_max).all()
    if tel.beta and tel.watermarks:
        full = Watermarks.from_record(res.beta, freq)
        assert np.array_equal(res.watermarks.peak_record, full.peak_record)
        assert np.array_equal(res.watermarks.beta_abs_max,
                              full.beta_abs_max)
        assert np.array_equal(res.watermarks.nu_min_ppm, full.nu_min_ppm)

    times = (np.arange(1, records + 1) * rec) * dt
    ss = simulate_ensemble(topo, links, ControllerConfig(kp=kp),
                           ppm[:subset],
                           SimConfig(dt=dt, steps=steps, record_every=rec,
                                     record_beta=False))
    err_ss = float(np.abs(freq[:subset] - ss.freq_ppm).max())
    bar = max(FREQ_ATOL_PPM, float32_floor_ppm(
        kp, int(topo.in_degree.max()), float(np.abs(psi).max())))

    args, mask = fused_inputs(topo, links, ppm, kp, dev)
    c = args[3].shape[0]
    dt_frames = float(125e6 * dt)
    kw = dict(num_records=records, record_every=rec, ctrl_mask=mask,
              record_beta=tel.beta, record_watermarks=tel.watermarks)
    # The fused kernel's row lists, built once for the timed launches (the
    # main path builds them once per call).
    kkw = dict(kw, lists=row_lists(args[3])) if engine == "fused" else kw
    kernel_ms = cuda_ms(lambda: kernel(*args, dt_frames, **kkw), reps)
    got = kernel(*args, dt_frames, **kkw)
    if engine == "fused":
        plan = fused_plan_of(args, dev)
        assert fused_device_plan() == plan, (fused_device_plan(), plan)
    else:
        plan = tiled_launch_plan(b, n)
    host = lambda x: x.transpose(0, 1).cpu().numpy()
    assert np.array_equal(host(got.freq * 1e6), freq), \
        f"{name}: the compared launch differs from the main path's"
    if tel.beta:
        assert np.array_equal(host(got.beta), res.beta)
    # The call's wall again (median of 3; host times vary from call to
    # call) beside its pieces.
    walls = [timed(lambda: simulate_ensemble_dense(
        topo, links, ppm, steps, kp, dt=dt, record_every=rec,
        telemetry=tel))[1] for _ in range(3)]
    split = host_split(topo, links, got, tel, dev)
    split["wall_s_median3"] = float(np.median(walls))
    split["rest_of_call_s"] = (split["wall_s_median3"] - kernel_ms * 1e-3
                               - split["host_stack_scatter_s"]
                               - split["stack_to_card_s"]
                               - split["records_to_host_s"])

    if plain_depth is None:
        pkw, same_ms = kw, kernel_ms
    else:
        pkw = dict(kw, num_records=plain_depth[0],
                   record_every=plain_depth[1])
        got = kernel(*args, dt_frames, **dict(kkw, **pkw))
        same_ms = cuda_ms(lambda: kernel(*args, dt_frames,
                                         **dict(kkw, **pkw)), 3)
    want, plain_s = timed(lambda: bittide_fused_torch(*args, dt_frames,
                                                      **pkw))
    err = kernel_vs_plain(got, want)
    nnz = float((args[3] != 0).sum())
    bound_ms, bound_by = bound(b, n, c, nnz, records * rec, records,
                               tel.beta, tel.watermarks)
    latency = {}
    if engine == "fused":
        clock = max_sm_clock_mhz()
        lat_ms, period = fused_latency_bound(
            kkw["lists"][1].shape[0], c, n,
            records * rec, records, tel.beta or tel.watermarks,
            sync_cycles(plan, c), clock)
        latency = dict(latency_bound_ms=lat_ms,
                       latency_bound_cycles_per_period=period,
                       latency_bound_sync_cycles=sync_cycles(plan, c),
                       max_sm_clock_mhz=clock)
    summ = summary(freq, times)
    out = dict(phase=name, topology=topo.name, nodes=n, draws=b,
               steps=steps, record_every=rec, dt=dt, kp=kp, engine=engine,
               stack_bytes=4 * c * n * n, launches=launches,
               launch_plan=plan, wall_s=wall, kernel_ms=kernel_ms,
               node_steps_per_s_kernel=b * n * steps / (kernel_ms * 1e-3),
               node_steps_per_s_wall=b * n * steps / wall,
               max_memory_allocated=mem, **split,
               segment_sum_draws=subset,
               freq_err_vs_segment_sum_ppm=err_ss,
               holds_freq_atol_ppm=err_ss <= FREQ_ATOL_PPM,
               segment_sum_bar_ppm=bar, plain_ms=plain_s * 1e3,
               plain_work=("the main path's" if plain_depth is None else
                           f"{plain_depth[0]} records x {plain_depth[1]} "
                           "periods" + (" + measure passes"
                                        if tel.beta or tel.watermarks
                                        else "")),
               kernel_ms_same_work=same_ms, kernel_vs_plain_draws=b,
               **{f"kernel_vs_plain_{k}": v for k, v in err.items()},
               bound_ms=bound_ms, bound_by=bound_by, **latency, **summ)
    assert err_ss <= bar, out
    assert summ["converged_draws"] == b, out
    return out, args, kw, res


def ring_report(plan, dplan, stack_bytes, ms_per_pass) -> dict:
    """How a streaming dense kernel (tiled or per-step) ran: the stack's
    bytes per pass over the time per pass against PEAK_BYTES_PER_S, and
    its ring (stages, rows per CTA, sources per panel, CTAs, CTAs resident
    per SM).  ``plan`` is the Python launch plan, ``dplan`` what the built
    library reports for the card; they must agree."""
    for key in ("smem_bytes", "stages", "tile_i", "tile_j"):
        assert plan[key] == dplan[key], (key, plan, dplan)
    rate = stack_bytes / (ms_per_pass * 1e-3)
    ctas = 1
    for g in plan["grid"]:
        ctas *= g
    return dict(stream_bytes_per_pass=stack_bytes,
                achieved_bytes_per_s=rate,
                achieved_share_of_peak=rate / PEAK_BYTES_PER_S,
                ring_stages=plan["stages"], rows_per_cta=plan["tile_i"],
                sources_per_panel=plan["tile_j"], ctas=ctas,
                threads_per_cta=plan["threads"],
                ctas_per_sm=dplan["ctas_per_sm"],
                smem_bytes_per_cta=plan["smem_bytes"])


def run_tiled(dev, k=22, b=8, steps=2_000, rec=100):
    """Phase 6: the tiled lane at Fig-18 size (see the module docstring)."""
    import torch
    from repro_torch.core import torus3d
    from repro_torch.kernels.bittide_step import (bittide_tiled, device_plan,
                                                  tiled_launch_plan)
    from repro_torch.telemetry import Telemetry
    out, args, kw, res = run_main_path(
        "tiled", torus3d(k), b, 2e-8, 5e-3, steps, rec,
        Telemetry(watermarks=True), dev, "tiled", subset=b, reps=1,
        plain_depth=(2, 2))
    n = out["nodes"]
    records = steps // rec
    passes = steps + records
    dt_frames = float(125e6 * out["dt"])
    c = args[3].shape[0]
    nnz = float((args[3] != 0).sum())
    pass_bound = bound(b, n, c, nnz, 1, 0, False, False)
    out.update(kernel_passes=passes,
               kernel_ms_per_pass=out["kernel_ms"] / passes,
               dense_stream_bound_ms=passes * 4 * n * n / PEAK_BYTES_PER_S
               * 1e3,
               bound_ms_per_pass=pass_bound[0],
               bound_by_per_pass=pass_bound[1],
               plain_passes=2 * 2 + 2,
               plain_ms_per_pass=out["plain_ms"] / (2 * 2 + 2),
               **ring_report(tiled_launch_plan(b, n, c),
                             device_plan("bittide_tiled", min(b, 8)),
                             out["stack_bytes"],
                             out["kernel_ms"] / passes))

    # Yardstick (not used by the port): one fp32 torch.matmul of the
    # per-pass aggregation's shapes, (B, N) x (N, N), times the passes.
    x = torch.randn(b, n, device=dev)
    mm_ms = cuda_ms(lambda: torch.matmul(x, args[3][0]), 5)
    out.update(library_ms_per_pass=mm_ms)
    emit(dict(phase="tiled", yardstick="torch.matmul (B,N)x(N,N) fp32 per "
              "pass, not used by the port", matmul_ms_per_pass=mm_ms,
              matmul_ms_all_passes=mm_ms * passes, passes=passes))

    # The stack's panels copied 16 bytes at a time (the main path) against
    # 4 bytes at a time: the same stack stored one float past a 16-byte
    # boundary takes the kernel's 4-byte path.  Same work, same bits.
    buf = torch.empty(args[3].numel() + 1, device=dev)
    a_off = buf[1:].view_as(args[3])
    a_off.copy_(args[3])
    off_args = args[:3] + (a_off,) + args[4:]
    ab = dict(kw, num_records=2, record_every=50)
    g16 = bittide_tiled(*args, dt_frames, **ab)
    g4 = bittide_tiled(*off_args, dt_frames, **ab)
    assert torch.equal(g16.freq, g4.freq) and torch.equal(g16.psi, g4.psi)
    ms = dict(b16=[], b4=[])
    for key in ("b16", "b4", "b4", "b16"):
        ms[key].append(cuda_ms(lambda: bittide_tiled(
            *(args if key == "b16" else off_args), dt_frames, **ab), 2))
    ab_passes = 2 * 50 + 2
    out.update(panel_copy_ms_per_pass_16B=[t / ab_passes for t in ms["b16"]],
               panel_copy_ms_per_pass_4B=[t / ab_passes for t in ms["b4"]])
    del buf, a_off, off_args
    return out, res


@contextlib.contextmanager
def recorded_engine_calls(module=None, name="_fused_engine"):
    """Record every call of the engine entry ``name`` in ``module`` (the
    scenario runner's dense engine by default; ``_sparse_engine`` for the
    sparse lane, and ``repro_torch.kernels.ops`` for the runners of
    ``simulate_ensemble_dense``), as (its arguments by name, its
    outputs)."""
    import inspect
    if module is None:
        from repro_torch.scenarios import runner as module
    inner = getattr(module, name)
    sig = inspect.signature(inner)
    calls = []

    def record(*args, **kw):
        out = inner(*args, **kw)
        bound_args = sig.bind(*args, **kw)
        bound_args.apply_defaults()
        calls.append((dict(bound_args.arguments), out))
        return out
    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, inner)


def sparse_call_args(a):
    """(args, kw) of ``bittide_sparse`` for one recorded ``_sparse_engine``
    call."""
    args = (a["psi"], a["nu"], a["nu_u"], a["nbr"], a["latf"], a["w"],
            a["lamsum"], a["kp"], a["beta_off"], a["dt_frames"])
    kw = dict(num_records=a["num_records"], record_every=a["record_every"],
              ctrl_mask=a["ctrl_mask"], record_beta=a["record_beta"],
              record_watermarks=a["record_watermarks"],
              record_guard=a["record_guard"], guard_lo=a["guard_lo"],
              guard_hi=a["guard_hi"], guard_stop=a["guard_stop"])
    return args, kw


def hold_sparse_calls(calls) -> dict:
    """Hold each recorded sparse-engine call against the plain version on
    the call's own inputs, at its full depth and at 0.0 error (records up
    to the guard's freeze, trip records equal); returns the worst errors
    and the number of calls held."""
    from repro_torch.kernels.bittide_sparse import bittide_sparse_torch
    worst = dict(calls=0, freq_ppm=0.0, beta_frames=0.0, psi_frames=0.0)
    for a, out in calls:
        args, kw = sparse_call_args(a)
        want = bittide_sparse_torch(*args, **kw)
        valid = kw["num_records"]
        if kw["record_guard"]:
            valid = min(int(want.guard_state.min()), kw["guard_stop"]) + 1
        err = kernel_vs_plain(out, want, records=valid, exact=True)
        worst["calls"] += 1
        worst["freq_ppm"] = max(worst["freq_ppm"], err["freq_err_ppm"])
        worst["beta_frames"] = max(worst["beta_frames"],
                                   err.get("beta_err_frames", 0.0))
        worst["psi_frames"] = max(worst["psi_frames"], err["psi_err_frames"])
    return worst


def dense_call_args(a):
    """(args, kw) of ``bittide_fused`` / ``bittide_tiled`` for one recorded
    ``_fused_engine`` call."""
    args = (a["psi"], a["nu"], a["nu_u"], a["a_t"], a["deg"], a["lamsum"],
            a["lat"], a["kp"], a["beta_off"], a["dt_frames"])
    kw = dict(num_records=a["num_records"], record_every=a["record_every"],
              ctrl_mask=a["ctrl_mask"], record_beta=a["record_beta"],
              record_watermarks=a["record_watermarks"],
              record_guard=a["record_guard"], guard_lo=a["guard_lo"],
              guard_hi=a["guard_hi"], guard_stop=a["guard_stop"])
    return args, kw


def hold_engine_calls(calls, max_records: int, exact: bool = False) -> dict:
    """Hold each recorded engine call against the plain version on the
    call's own inputs (B, N, C, variant, guard band and stop cap): the
    call's own outputs when it ran at most ``max_records`` records, else
    the kernel launched again on its inputs for its first ``max_records``
    records.  Raises when one leaves its bar (``kernel_vs_plain``; with
    ``exact``, any error but 0.0); returns per kernel the worst errors and
    the number of calls held."""
    from repro_torch.kernels.bittide_step import (bittide_fused,
                                                  bittide_fused_torch,
                                                  bittide_tiled)
    worst = {}
    for a, out in calls:
        name = "bittide_" + a["engine"]
        args, kw = dense_call_args(a)
        if kw["num_records"] > max_records:
            kw["num_records"] = max_records
            if kw["record_guard"]:
                kw["guard_stop"] = min(kw["guard_stop"], max_records - 1)
            if name == "bittide_fused":
                out = bittide_fused(*args, **kw, lists=a["lists"])
            else:
                out = bittide_tiled(*args, **kw)
        want = bittide_fused_torch(*args, **kw)
        valid = kw["num_records"]
        if kw["record_guard"]:
            valid = min(int(want.guard_state.min()), kw["guard_stop"]) + 1
        err = kernel_vs_plain(out, want, records=valid, exact=exact)
        w = worst.setdefault(name, dict(calls=0, freq_ppm=0.0,
                                        beta_frames=0.0, psi_frames=0.0))
        w["calls"] += 1
        w["freq_ppm"] = max(w["freq_ppm"], err["freq_err_ppm"])
        w["beta_frames"] = max(w["beta_frames"],
                               err.get("beta_err_frames", 0.0))
        w["psi_frames"] = max(w["psi_frames"], err["psi_err_frames"])
    return worst


def run_scenarios(dev, b=256, steps=40_000):
    """Phase 7: run_scenario on the cable swap and the guarded torus."""
    import numpy as np
    import torch
    from repro_torch.core import (ControllerConfig, ReframePolicy, SimConfig,
                                  fully_connected, make_links, torus3d)
    from repro_torch.kernels import EngineOptions
    from repro_torch.kernels.bittide_step import bittide_fused, bittide_tiled
    from repro_torch.scenarios import (DriftRamp, LatencyStep, Scenario,
                                       edges_between, run_scenario)
    from repro_torch.telemetry import Telemetry
    topo = fully_connected(8)
    links = make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(0).uniform(-8, 8, (b, 8)).astype(np.float32)
    ctrl = ControllerConfig(kp=2e-8)
    swap = edges_between(topo, 0, 2)

    def cable_swap(steps):
        return (Scenario(events=(LatencyStep(t=steps * 1e-4 / 2, edges=swap,
                                             cable_m=1000.0,
                                             reestablish=True),),
                         name="fiber-spool-swap"),
                SimConfig(dt=1e-4, steps=steps, record_every=20))

    sc, cfg = cable_swap(steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bittide_fused.launches = 0
    t0 = time.perf_counter()
    with recorded_engine_calls() as calls:
        res = run_scenario(topo, links, ctrl, ppm, sc, cfg,
                           options=EngineOptions(engine="fused"),
                           telemetry=Telemetry(beta=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bittide_fused.launches
    mem = torch.cuda.max_memory_allocated()
    assert launches >= 1, "the scenario path launched no fused kernel"
    assert res.engine == "fused" and res.freq_ppm.shape == (b, steps // 20, 8)
    assert np.isfinite(res.freq_ppm).all() and np.isfinite(res.beta).all()
    rtt_shift = int((res.rtt(1) - res.rtt(0))[swap[0]])
    assert abs(rtt_shift - 1231) <= 3, rtt_shift
    spread = res.freq_ppm[:, -1].max(axis=1) - res.freq_ppm[:, -1].min(
        axis=1)
    held = hold_engine_calls(calls, max_records=50)
    del calls

    sc_s, cfg_s = cable_swap(4_000)
    lanes = {}
    for engine in ("fused", "segment-sum"):
        lanes[engine] = run_scenario(topo, links, ctrl, ppm, sc_s, cfg_s,
                                     options=EngineOptions(engine=engine))
    err = float(np.abs(lanes["fused"].freq_ppm
                       - lanes["segment-sum"].freq_ppm).max())
    bar = max(FREQ_ATOL_PPM, float32_floor_ppm(
        2e-8, 7, float(np.abs(lanes["fused"].psi).max())))
    smoke_shift = int((lanes["segment-sum"].rtt(1)
                       - lanes["segment-sum"].rtt(0))[swap[0]])
    out = dict(phase="scenario", topology=topo.name, draws=b, steps=steps,
               record_every=20, dt=1e-4, kp=2e-8, engine=res.engine,
               launches=launches, engine_calls=res.num_launches,
               wall_s=wall, node_steps_per_s_wall=b * 8 * steps / wall,
               max_memory_allocated=mem, rtt_shift_frames=rtt_shift,
               final_band_ppm_max=float(spread.max()),
               kernel_vs_plain=held["bittide_fused"],
               kernel_vs_plain_records=50,
               smoke_steps=4_000, smoke_freq_err_vs_segment_sum_ppm=err,
               smoke_bar_ppm=bar, smoke_rtt_shift_segment_sum=smoke_shift)
    emit(out)
    assert err <= bar, out

    # The guarded torus of tests/test_reframing.py on the tiled (auto) and
    # the forced fused lane.
    topo = torus3d(8)
    links = make_links(topo, cable_m=2.0)
    p = np.random.default_rng(7).uniform(-0.25, 0.25, topo.num_nodes)
    ppm = (p - p.mean()).astype(np.float32)
    sc = Scenario(events=(
        DriftRamp(t=0.048, t_end=0.24, nodes=tuple(range(64)),
                  rate_ppm_per_s=150.0),
        LatencyStep(t=0.288, edges=edges_between(topo, 0, 1),
                    cable_m=1000.0)), name="torus-drift-swap")
    cfg = SimConfig(dt=1e-3, steps=384, record_every=6)
    tel = Telemetry(beta=True, guard=ReframePolicy(depth=16, margin=5.0))
    runs = {}
    for engine, kernel in (("auto", bittide_tiled), ("fused", bittide_fused)):
        kernel.launches = 0
        with recorded_engine_calls() as calls:
            r = run_scenario(topo, links, ControllerConfig(kp=6e-7), ppm, sc,
                             cfg, options=EngineOptions(engine=engine),
                             telemetry=tel)
        launched = kernel.launches
        assert launched >= 1, f"the guarded torus ({engine}) launched no " \
            f"{kernel.__name__} kernel"
        runs[r.engine] = (r, launched, hold_engine_calls(calls, 10**9))
        del calls
    (til, til_launches, til_held), (fus, fus_launches, fus_held) = \
        runs["tiled"], runs["fused"]
    splices = [(x.record, np.asarray(x.shift).tolist())
               for x in til.reframes]
    guard = dict(phase="scenario_guard", topology=topo.name,
                 splices=len(til.reframes),
                 splice_records=[x.record for x in til.reframes],
                 identical_splices=splices == [
                     (x.record, np.asarray(x.shift).tolist())
                     for x in fus.reframes],
                 guard_latency_one=all(x.guard_latency == 1 for x in
                                       til.reframes + fus.reframes),
                 tiled_launches=til_launches, fused_launches=fus_launches,
                 tiled_kernel_vs_plain=til_held["bittide_tiled"],
                 fused_kernel_vs_plain=fus_held["bittide_fused"],
                 freq_tiled_vs_fused_ppm=float(
                     np.abs(til.freq_ppm - fus.freq_ppm).max()))
    emit(guard)
    assert guard["identical_splices"] and guard["guard_latency_one"], guard
    assert guard["splices"] >= 3, guard
    return dict(fused_launches=launches + fus_launches,
                tiled_launches=til_launches, swap_freq=res.freq_ppm[:16],
                swap_beta=res.beta[:16], rtt_shift=rtt_shift,
                held=[held["bittide_fused"], til_held["bittide_tiled"],
                      fus_held["bittide_fused"]],
                held_kernels=["bittide_fused", "bittide_tiled",
                              "bittide_fused"])


def sparse_bound(b, n, k, e, steps, records, table_rows, wm):
    """(bound_ms, bound_by) for one call of the sparse kernel.

    Bytes: every input read once (the tables, (4 + 8·R)·K·N; ψ, ν, ν_u,
    lamsum; mask, gains), every output written once (ψ, ν, the ν records,
    the watermarks).  Operations: what the function needs on this run's
    data — the degrees once (K·N·R adds: the tables are fixed for the
    call), per period 4 per real edge (ν·lat, ψ − ·, w·, acc +) and 10
    per node, and per record's measure pass the row mean (N + chunks + 1
    per draw), 4 per edge and 8 per node (the node's centring ψ − mean
    among them: the gathers read centred ψ, not one subtraction each).
    """
    nodes = b * n
    in_bytes = (4 + 8 * table_rows) * k * n + 4 * (4 * nodes + n + 2 * b)
    out_bytes = 4 * (2 * nodes + records * nodes + 4 * wm * nodes)
    ops = k * n * table_rows + b * steps * (4 * e + 10 * n)
    if wm:
        ops += b * records * (n + -(-n // 1024) + 1 + 4 * e + 8 * n)
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def run_sparse(dev, k=100, b=8, steps=2_000, rec=100):
    """Phase 8: the sparse lane at full width (see the module docstring)."""
    import numpy as np
    import torch
    from repro_torch.core import (ControllerConfig, SimConfig, make_links,
                                  simulate_ensemble, torus3d)
    from repro_torch.core.frame_model import OMEGA_NOM
    from repro_torch.kernels import ops, simulate_ensemble_dense
    from repro_torch.kernels.bittide_sparse import (bittide_sparse,
                                                    bittide_sparse_torch,
                                                    ellify)
    from repro_torch.kernels.bittide_step import (sparse_device_plan,
                                                  sparse_launch_plan)
    from repro_torch.telemetry import Telemetry
    kp, dt = 2e-8, 5e-3
    t0 = time.perf_counter()
    topo = torus3d(k)
    topology_build_s = time.perf_counter() - t0
    n, e = topo.num_nodes, topo.num_edges
    links = make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(0).uniform(-8, 8, (b, n))
    tel = Telemetry(watermarks=True)
    records = steps // rec
    call = lambda: simulate_ensemble_dense(topo, links, ppm, steps, kp,
                                           dt=dt, record_every=rec,
                                           telemetry=tel)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bittide_sparse.launches = 0
    t0 = time.perf_counter()
    with recorded_engine_calls(ops, "_sparse_engine") as calls:
        res = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bittide_sparse.launches
    mem = torch.cuda.max_memory_allocated()
    assert launches >= 1, "sparse: the main path launched no sparse kernel"
    assert res.engine == "sparse", res.engine
    freq, psi = res
    assert freq.shape == (b, records, n), freq.shape
    assert np.isfinite(freq).all() and np.isfinite(psi).all()
    assert np.isfinite(res.watermarks.beta_abs_max).all()
    (a, out), = calls
    del calls
    args, kw = sparse_call_args(a)

    # One more launch on the main path's inputs reproduces its records,
    # by the plan Python computed.
    again = bittide_sparse(*args, **kw)
    plan = sparse_launch_plan(b, n, int(args[3].shape[0]),
                              args[4].shape[0] == args[5].shape[0] == 1)
    assert sparse_device_plan() == plan, (sparse_device_plan(), plan)
    host = lambda x: x.transpose(0, 1).cpu().numpy()
    assert np.array_equal(host(again.freq * 1e6), freq), \
        "sparse: the compared launch differs from the main path's"
    del again
    kernel_ms = cuda_ms(lambda: bittide_sparse(*args, **kw), 1)

    # The plain version over every draw at full depth.
    want, plain_s = timed(lambda: bittide_sparse_torch(*args, **kw))
    err = kernel_vs_plain(out, want, exact=True)
    del want

    # The segment-sum lane on the card over every draw.
    ss = simulate_ensemble(topo, links, ControllerConfig(kp=kp), ppm,
                           SimConfig(dt=dt, steps=steps, record_every=rec,
                                     record_beta=False))
    err_ss = float(np.abs(freq - ss.freq_ppm).max())
    bar = max(FREQ_ATOL_PPM, float32_floor_ppm(kp, 6,
                                               float(np.abs(psi).max())))
    del ss

    # The host side of the call, piece by piece (medians of 3), beside
    # the call's wall (median of 3 more calls).
    median = lambda fn: float(np.median([timed(fn)[1] for _ in range(3)]))
    from repro_torch.kernels.ops import _lamsum_host, latency_classes
    lat_f = np.asarray(links.latency_s, np.float64) * OMEGA_NOM
    tables = ellify(topo, lat_f)

    def back():
        host(out.freq * 1e6)
        out.psi.cpu(), out.nu.cpu()
        [x.cpu() for x in out.watermarks]
    split = dict(
        auto_probe_s=median(lambda: ops._auto_is_sparse(
            topo, b, lambda: len(latency_classes(lat_f, warn=False)[0]))),
        ellify_s=median(lambda: ellify(topo, lat_f)),
        lamsum_fold_s=median(lambda: _lamsum_host(
            topo, np.asarray(links.beta0)[None], None, 1)),
        tables_to_card_s=median(lambda: [torch.as_tensor(x, device=dev)
                                         for x in tables]),
        records_to_host_s=median(back))
    split["wall_s_median3"] = float(np.median([timed(call)[1]
                                               for _ in range(3)]))
    split["rest_of_call_s"] = split["wall_s_median3"] - kernel_ms * 1e-3 \
        - sum(v for key, v in split.items() if key.endswith("_s")
              and key not in ("wall_s_median3",))

    # Yardstick (not used by the port): each pass's aggregation as two
    # torch.sparse CSR products, w·ψ and (w·lat)·ν, on (N, B) operands.
    idx = torch.as_tensor(np.stack([topo.dst, topo.src]).astype(np.int64),
                          device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # "sparse CSR is in beta"
        w_csr = torch.sparse_coo_tensor(
            idx, torch.ones(e, device=dev), (n, n)).coalesce().to_sparse_csr()
        wl_csr = torch.sparse_coo_tensor(
            idx, torch.as_tensor(lat_f.astype(np.float32), device=dev),
            (n, n)).coalesce().to_sparse_csr()
    # Timed over all of phase 8's passes in one run of CUDA events, each
    # pass's products dropped before the next.
    xp = args[0].t().contiguous()
    xn = args[2].t().contiguous()
    passes = steps + records

    def spmm_passes(count):
        for _ in range(count):
            torch.sparse.mm(w_csr, xp), torch.sparse.mm(wl_csr, xn)
    spmm_passes(1)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    spmm_passes(passes)
    stop.record()
    torch.cuda.synchronize()
    library_ms = start.elapsed_time(stop)
    del w_csr, wl_csr, xp, xn

    bound_ms, bound_by = sparse_bound(b, n, int(args[3].shape[0]), e, steps,
                                      records, int(args[4].shape[0]), True)
    band = freq[:, -1].max(axis=1) - freq[:, -1].min(axis=1)
    out_row = dict(
        phase="sparse", topology=topo.name, nodes=n, edges=e, draws=b,
        k=int(args[3].shape[0]), steps=steps, record_every=rec, dt=dt, kp=kp,
        engine=res.engine, launch_plan=plan, launches=launches,
        passes=passes, kernel_launches_per_call=steps + 3 * records,
        topology_build_s=topology_build_s, wall_s=wall, kernel_ms=kernel_ms,
        kernel_ms_per_pass=kernel_ms / passes,
        node_steps_per_s_kernel=b * n * steps / (kernel_ms * 1e-3),
        node_steps_per_s_wall=b * n * steps / wall,
        max_memory_allocated=mem, **split,
        plain_ms=plain_s * 1e3, plain_work="the main path's (full depth)",
        kernel_vs_plain_draws=b,
        **{f"kernel_vs_plain_{key}": v for key, v in err.items()},
        segment_sum_draws=b, freq_err_vs_segment_sum_ppm=err_ss,
        segment_sum_bar_ppm=bar, bound_ms=bound_ms, bound_by=bound_by,
        period_stream_bound_ms_per_pass=(
            (12 * int(args[3].shape[0]) * n + 24 * b * n)
            / PEAK_BYTES_PER_S * 1e3),
        library_ms=library_ms, library_ms_per_pass=library_ms / passes,
        final_band_ppm_max=float(band.max()),
        final_band_ppm_p50=float(np.median(band)))
    assert err_ss <= bar, out_row
    return out_row


def run_sparse_fig18(dev, tiled, k=22, b=8, steps=2_000, rec=100):
    """Phase 8b: phase 6's run (torus3d(22), same draws and settings) on
    the sparse lane instead of the tiled one; both kernels timed with CUDA
    events in this run on the main path's own inputs."""
    import numpy as np
    from repro_torch.core import make_links, torus3d
    from repro_torch.kernels import EngineOptions, ops, simulate_ensemble_dense
    from repro_torch.kernels.bittide_sparse import bittide_sparse
    from repro_torch.telemetry import Telemetry
    topo = torus3d(k)
    n = topo.num_nodes
    ppm = np.random.default_rng(0).uniform(-8, 8, (b, n))
    with recorded_engine_calls(ops, "_sparse_engine") as calls:
        res = simulate_ensemble_dense(
            topo, make_links(topo, cable_m=2.0), ppm, steps, 2e-8, dt=5e-3,
            record_every=rec, options=EngineOptions(engine="sparse"),
            telemetry=Telemetry(watermarks=True))
    (a, _), = calls
    args, kw = sparse_call_args(a)
    sparse_ms = cuda_ms(lambda: bittide_sparse(*args, **kw), 3)
    times = (np.arange(1, steps // rec + 1) * rec) * 5e-3
    row = dict(phase="sparse_fig18", topology=topo.name, nodes=n, draws=b,
               steps=steps, record_every=rec, engine=res.engine,
               sparse_kernel_ms=sparse_ms, tiled_kernel_ms=tiled["kernel_ms"],
               tiled_over_sparse=tiled["kernel_ms"] / sparse_ms,
               **summary(res[0], times))
    assert row["converged_draws"] == b, row
    return row


def traced_triage_s(trace) -> float:
    """The seconds a campaign's run spent in triage, from its own flight
    recorder: from the end of the last record before the first
    ``chaos_draw`` event (the batched run's end) to that event (triage
    runs in between, then the draws' events are written)."""
    first = min(ev.t for ev in trace.by_kind("chaos_draw"))
    ends = [ev.t + (ev.dur or 0.0) for ev in trace.events if ev.t < first]
    return first - max(ends)


def run_chaos(dev, draws=1024):
    """Phase 9: two chaos campaigns on the sparse lane (see the module
    docstring)."""
    import numpy as np
    import torch
    from repro_torch.core import (ControllerConfig, SimConfig, make_links,
                                  torus3d)
    from repro_torch.kernels import EngineOptions
    from repro_torch.kernels.bittide_sparse import bittide_sparse
    from repro_torch.scenarios import (ChaosCampaign, DriftRampSampler,
                                       FreqStepSampler, LatencyStepSampler,
                                       LinkDropSampler, edges_between,
                                       run_scenario, runner)
    from repro_torch.telemetry import Telemetry
    topo = torus3d(8)
    links = make_links(topo, cable_m=2.0)
    ctrl = ControllerConfig(kp=2e-8)
    out = {}

    # 1. examples/chaos_campaign.py's full campaign on the sparse lane.
    steps = 4800
    cfg = SimConfig(dt=1e-3, steps=steps, record_every=24)
    t_hold = steps * cfg.dt
    camp = ChaosCampaign(
        topo=topo, ctrl=ctrl,
        samplers=(
            FreqStepSampler(t=0.15 * t_hold, ppm_range=(0.05, 6.0)),
            DriftRampSampler(t=0.35 * t_hold, t_end=0.6 * t_hold,
                             rate_range=(0.05, 2.0)),
            LatencyStepSampler(t=0.5 * t_hold,
                               edges=edges_between(topo, 0, 1),
                               cable_range=(5.0, 200.0))),
        num_draws=draws, seed=0, ppm_range=0.05, links=links, cfg=cfg,
        engine="sparse", auto_reframe=True, depth=32, name="torus512")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bittide_sparse.launches = 0
    t0 = time.perf_counter()
    with recorded_engine_calls(runner, "_sparse_engine") as calls:
        result = camp.run(telemetry=Telemetry(trace=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bittide_sparse.launches
    mem = torch.cuda.max_memory_allocated()
    assert launches >= 1 and result.result.engine == "sparse"
    assert np.isfinite(result.result.freq_ppm).all()
    # Where the wall goes: the engine calls (the trace's chunk spans: the
    # launches, the guard's trip read and the record copies), triage (read
    # off the same trace), and the rest (segment prep, rotations, the
    # build).
    chunk_s = sum(ev.dur for ev in result.result.trace.by_kind("chunk"))
    triage_s = traced_triage_s(result.result.trace)
    held = hold_sparse_calls(calls)
    del calls
    shrunk = result.shrink()
    t0 = time.perf_counter()
    reproduces = shrunk.reproduces
    shrink_s = time.perf_counter() - t0
    row = dict(phase="chaos", campaign=camp.name, topology=topo.name,
               draws=draws, steps=steps, record_every=24, engine="sparse",
               launches=launches, engine_calls=result.result.num_launches,
               splices=len(result.result.reframes), wall_s=wall,
               engine_calls_s=chunk_s, triage_s=triage_s,
               rest_of_wall_s=wall - chunk_s - triage_s,
               node_steps_per_s_wall=draws * topo.num_nodes * steps / wall,
               max_memory_allocated=mem, verdicts=result.counts(),
               survival_rate=result.survival_rate(),
               worst_draw=shrunk.draw_index,
               worst_verdict=shrunk.expected_verdict,
               shrink_reproduces=reproduces, shrink_replay_s=shrink_s,
               kernel_vs_plain=held)
    emit(row)
    assert reproduces, row
    assert sum(row["verdicts"].values()) == draws, row
    out["launches"] = launches
    out["held"] = [held]

    # 2. Per-draw LinkDrop victims (per-draw slot weights) + FreqStep,
    # against the segment-sum lane on the card.
    cfg2 = SimConfig(dt=1e-3, steps=240, record_every=12)
    camp2 = ChaosCampaign(
        topo=topo, ctrl=ctrl,
        samplers=(FreqStepSampler(t=0.06, ppm_range=(1.0, 4.0)),
                  LinkDropSampler(t=0.1, t_restore=0.16)),
        num_draws=draws, seed=5, ppm_range=8.0, links=links, cfg=cfg2,
        engine="sparse", name="torus512-linkdrop")
    bittide_sparse.launches = 0
    t0 = time.perf_counter()
    with recorded_engine_calls(runner, "_sparse_engine") as calls:
        result2 = camp2.run()
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    launches2 = bittide_sparse.launches
    assert launches2 >= 1 and result2.result.engine == "sparse"
    assert any(a["w"].shape[0] == draws for a, _ in calls), \
        "the LinkDrop campaign ran no per-draw weight table"
    held2 = hold_sparse_calls(calls)
    del calls
    seg = run_scenario(topo, links, ctrl, result2.ppm_u, result2.scenario,
                       cfg2, options=EngineOptions(engine="segment-sum"),
                       telemetry=Telemetry(beta=True))
    err = float(np.abs(result2.result.freq_ppm - seg.freq_ppm).max())
    row2 = dict(phase="chaos", campaign=camp2.name, topology=topo.name,
                draws=draws, steps=240, record_every=12, engine="sparse",
                launches=launches2, engine_calls=result2.result.num_launches,
                wall_s=wall2, verdicts=result2.counts(),
                freq_err_vs_segment_sum_ppm=err,
                segment_sum_bar_ppm=LINKDROP_ATOL_PPM, kernel_vs_plain=held2)
    emit(row2)
    assert err <= LINKDROP_ATOL_PPM, row2
    out["launches"] += launches2
    out["held"].append(held2)
    return out


def perstep_call_args(a):
    """(args, kw) of ``bittide_perstep`` for one recorded
    ``_perstep_engine`` call."""
    args = (a["psi"], a["nu"], a["nu_u"], a["a_t"], a["deg"], a["lamsum"],
            a["lat"], a["kp"], a["beta_off"], a["dt_frames"])
    kw = dict(num_records=a["num_records"], record_every=a["record_every"],
              ctrl_mask=a["ctrl_mask"], record_beta=a["record_beta"],
              record_watermarks=a["record_watermarks"],
              record_guard=a["record_guard"], guard_lo=a["guard_lo"],
              guard_hi=a["guard_hi"], guard_stop=a["guard_stop"])
    return args, kw


def hold_perstep_calls(calls, max_records: int) -> dict:
    """Hold each recorded per-step engine call against the plain version
    on the call's own inputs at 0.0 error: the call's own outputs when it
    ran at most ``max_records`` records, else the kernel launched again
    on its inputs for its first ``max_records`` records (the stop cap
    clipped to them).  Returns the worst errors and the calls held."""
    from repro_torch.kernels.bittide_step import (bittide_perstep,
                                                  bittide_perstep_torch)
    worst = dict(calls=0, freq_ppm=0.0, beta_frames=0.0, psi_frames=0.0)
    for a, out in calls:
        args, kw = perstep_call_args(a)
        if kw["num_records"] > max_records:
            kw["num_records"] = max_records
            if kw["record_guard"]:
                kw["guard_stop"] = min(kw["guard_stop"], max_records - 1)
            out = bittide_perstep(*args, **kw)
        want = bittide_perstep_torch(*args, **kw)
        err = kernel_vs_plain(out, want, exact=True)
        worst["calls"] += 1
        worst["freq_ppm"] = max(worst["freq_ppm"], err["freq_err_ppm"])
        worst["beta_frames"] = max(worst["beta_frames"],
                                   err.get("beta_err_frames", 0.0))
        worst["psi_frames"] = max(worst["psi_frames"], err["psi_err_frames"])
    return worst


def run_perstep(dev, tiled_res, scen, k=22, steps=2_000, rec=100,
                swap_steps=40_000, swap_draws=16):
    """Phase 10: the per-step lane (see the module docstring)."""
    import numpy as np
    import torch
    from repro_torch.core import (BittideNetwork, ControllerConfig,
                                  ReframePolicy, SimConfig, fully_connected,
                                  make_links, torus3d)
    from repro_torch.kernels import (EngineOptions, ops,
                                     simulate_ensemble_dense)
    from repro_torch.kernels.bittide_step import (bittide_perstep,
                                                  bittide_perstep_torch,
                                                  device_plan,
                                                  perstep_launch_plan)
    from repro_torch.scenarios import (DriftRamp, LatencyStep, Scenario,
                                       edges_between, runner)
    from repro_torch.telemetry import Telemetry
    out = {}

    # (a) Full width at Fig-18 scale: draws 0 and 1 of phase 6.
    topo = torus3d(k)
    n = topo.num_nodes
    links = make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(0).uniform(-8, 8, (8, n))[:2]
    records = steps // rec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bittide_perstep.launches = 0
    t0 = time.perf_counter()
    with recorded_engine_calls(ops, "_perstep_engine") as calls:
        res = simulate_ensemble_dense(
            topo, links, ppm, steps, 2e-8, dt=5e-3, record_every=rec,
            options=EngineOptions(engine="per-step"),
            telemetry=Telemetry(watermarks=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_a = bittide_perstep.launches
    mem = torch.cuda.max_memory_allocated()
    assert launches_a == 2 * (steps + 2 * records), launches_a
    assert res.engine == "per-step" and res[0].shape == (2, records, n)
    assert np.isfinite(res[0]).all()
    tiled_freq, tiled_wm = tiled_res[0][:2], tiled_res.watermarks
    err_tiled = float(np.abs(res[0] - tiled_freq).max())
    wm_same = all(np.array_equal(getattr(res.watermarks, f),
                                 getattr(tiled_wm, f)[:2])
                  for f in ("beta_abs_max", "peak_record", "nu_min_ppm",
                            "nu_max_ppm"))
    assert err_tiled <= FREQ_ATOL_PPM, err_tiled
    assert np.array_equal(res.watermarks.peak_record,
                          tiled_wm.peak_record[:2])
    assert float(np.abs(res.watermarks.nu_max_ppm
                        - tiled_wm.nu_max_ppm[:2]).max()) <= FREQ_ATOL_PPM
    (a, _), _ = calls
    args, kw = perstep_call_args(a)
    passes = steps + records
    call_ms = cuda_ms(lambda: bittide_perstep(*args, **kw), 1)
    # The plain version over 2 records x 2 periods with the measure pass,
    # against the kernel on the same work.
    pkw = dict(kw, num_records=2, record_every=2)
    got = bittide_perstep(*args, **pkw)
    want, plain_s = timed(lambda: bittide_perstep_torch(*args, **pkw))
    err = kernel_vs_plain(got, want, exact=True)
    same_ms = cuda_ms(lambda: bittide_perstep(*args, **pkw), 3)
    # Yardstick (not used by the port): the aggregation of one period as
    # one torch.mv per latency class.
    x = torch.randn(n, device=dev)
    a_t = args[3]
    mv_ms = cuda_ms(lambda: [torch.mv(a_t[c].t(), x)
                             for c in range(a_t.shape[0])], 5)
    nnz = float((a_t != 0).sum())
    bound_ms, bound_by = bound(1, n, a_t.shape[0], nnz, 1, 0, False, False)
    out["a"] = dict(
        phase="perstep", topology=topo.name, nodes=n, draws=2, steps=steps,
        record_every=rec, dt=5e-3, kp=2e-8, engine=res.engine,
        stack_bytes=4 * a_t.shape[0] * n * n, launches=launches_a,
        wall_s=wall, max_memory_allocated=mem, kernel_ms_per_draw=call_ms,
        kernel_passes_per_draw=passes,
        kernel_ms_per_pass=call_ms / passes,
        kernel_ms_per_period_with_measure=call_ms / steps,
        bound_ms_per_pass=bound_ms, bound_by=bound_by,
        library_ms_per_pass=mv_ms,
        library_note="one torch.mv per latency class: the aggregation of "
                     "one period only, not the update; not used by the port",
        plain_ms=plain_s * 1e3, plain_ms_per_pass=plain_s * 1e3 / 6,
        plain_work="2 records x 2 periods + measure passes",
        kernel_ms_same_work=same_ms,
        **{f"kernel_vs_plain_{key}": v for key, v in err.items()},
        freq_err_vs_tiled_ppm=err_tiled,
        bit_identical_to_tiled=bool(np.array_equal(res[0], tiled_freq)),
        watermarks_identical_to_tiled=wm_same,
        **ring_report(perstep_launch_plan(n, a_t.shape[0]),
                      device_plan("bittide_step"), 4 * a_t.numel(),
                      call_ms / passes),
        **summary(res[0], (np.arange(1, records + 1) * rec) * 5e-3))
    emit(out["a"])
    # A draw's bits are the tiled lane's: ν and every watermark.
    assert out["a"]["bit_identical_to_tiled"], out["a"]
    assert out["a"]["watermarks_identical_to_tiled"], out["a"]
    del calls, args, kw, a_t, got, want

    # (b) The cable swap through the facade, 40,000 periods, the first 16
    # of phase 7's draws.
    fc8 = fully_connected(8)
    ppm = np.random.default_rng(0).uniform(-8, 8, (256, 8)).astype(
        np.float32)[:swap_draws]
    net = BittideNetwork(topo=fc8, links=make_links(fc8, cable_m=2.0),
                         ppm_u=ppm)
    swap = edges_between(fc8, 0, 2)
    sc = Scenario(events=(LatencyStep(t=swap_steps * 1e-4 / 2, edges=swap,
                                      cable_m=1000.0, reestablish=True),),
                  name="fiber-spool-swap")
    bittide_perstep.launches = 0
    t0 = time.perf_counter()
    with recorded_engine_calls(runner, "_perstep_engine") as calls:
        sw = net.run_scenario(sc, ControllerConfig(kp=2e-8),
                              SimConfig(dt=1e-4, steps=swap_steps,
                                        record_every=20),
                              options=EngineOptions(engine="per-step"),
                              telemetry=Telemetry(beta=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_b = bittide_perstep.launches
    assert launches_b >= 1 and sw.engine == "per-step"
    shift = int((sw.rtt(1) - sw.rtt(0))[swap[0]])
    freq_err = float(np.abs(sw.freq_ppm - scen["swap_freq"]).max())
    beta_err = float(np.abs(sw.beta - scen["swap_beta"]).max())
    held = hold_perstep_calls(calls, max_records=10)
    del calls
    out["b"] = dict(
        phase="perstep_swap", entry="BittideNetwork.run_scenario",
        topology=fc8.name, draws=swap_draws, steps=swap_steps,
        record_every=20,
        launches=launches_b, engine_calls=sw.num_launches, wall_s=wall,
        rtt_shift_frames=shift, rtt_shift_fused=scen["rtt_shift"],
        freq_err_vs_fused_ppm=freq_err, beta_err_vs_fused_frames=beta_err,
        bit_identical_to_fused=bool(
            np.array_equal(sw.freq_ppm, scen["swap_freq"])
            and np.array_equal(sw.beta, scen["swap_beta"])),
        kernel_vs_plain=held, kernel_vs_plain_records=10)
    emit(out["b"])
    assert shift == scen["rtt_shift"], out["b"]
    assert freq_err <= FREQ_ATOL_PPM and beta_err <= BETA_ATOL_FRAMES, \
        out["b"]

    # (c) Phase 7's guarded torus on per-step with three draws whose
    # drift rates differ, so that their trips differ and the host resync
    # re-runs draws; against the forced fused lane on the same batch.
    topo = torus3d(8)
    links = make_links(topo, cable_m=2.0)
    p = np.random.default_rng(7).uniform(-0.25, 0.25, topo.num_nodes)
    ppm = np.tile((p - p.mean()).astype(np.float32), (3, 1))
    sc = Scenario(events=(
        DriftRamp(t=0.048, t_end=0.24, nodes=tuple(range(64)),
                  rate_ppm_per_s=np.array([150.0, 120.0, 180.0])),
        LatencyStep(t=0.288, edges=edges_between(topo, 0, 1),
                    cable_m=1000.0)), name="torus-drift-swap")
    cfg = SimConfig(dt=1e-3, steps=384, record_every=6)
    tel = Telemetry(beta=True, guard=ReframePolicy(depth=16, margin=5.0))
    bittide_perstep.launches = 0
    with recorded_engine_calls(runner, "_perstep_engine") as calls:
        ps = BittideNetwork(topo, links, ppm).run_scenario(
            sc, ControllerConfig(kp=6e-7), cfg,
            options=EngineOptions(engine="per-step"), telemetry=tel)
    launches_c = bittide_perstep.launches
    resync = len(calls) - 3 * ps.num_launches
    # Held: the first chunk's three draws and every resync re-run (a
    # draw's second call from the same state), over their first 2 records.
    seen, picked = set(), []
    for i, (a, o) in enumerate(calls):
        ptr = a["psi"].data_ptr()
        if i < 3 or ptr in seen:
            picked.append((a, o))
        seen.add(ptr)
    held_c = hold_perstep_calls(picked, 2)
    held_c["resync_calls"] = len(picked) - 3
    del calls, picked
    fu = BittideNetwork(topo, links, ppm).run_scenario(
        sc, ControllerConfig(kp=6e-7), cfg,
        options=EngineOptions(engine="fused"), telemetry=tel)
    splices = lambda r: [(x.record, np.asarray(x.shift).tolist())
                         for x in r.reframes]
    out["c"] = dict(
        phase="perstep_guard", topology=topo.name, draws=3,
        launches=launches_c, splices=len(ps.reframes),
        resync_draw_runs=resync,
        identical_splices_to_fused=splices(ps) == splices(fu),
        guard_latency_one=all(x.guard_latency == 1 for x in ps.reframes),
        freq_err_vs_fused_ppm=float(np.abs(ps.freq_ppm
                                           - fu.freq_ppm).max()),
        bit_identical_to_fused=bool(np.array_equal(ps.freq_ppm,
                                                   fu.freq_ppm)),
        kernel_vs_plain=held_c)
    emit(out["c"])
    assert out["c"]["identical_splices_to_fused"], out["c"]
    assert out["c"]["guard_latency_one"] and out["c"]["splices"] >= 3
    assert resync >= 1, out["c"]
    assert out["c"]["freq_err_vs_fused_ppm"] <= FREQ_ATOL_PPM, out["c"]

    out["launches"] = launches_a + launches_b + launches_c
    out["held"] = [dict(freq_ppm=err["freq_err_ppm"],
                        beta_frames=err.get("beta_err_frames", 0.0)),
                   held, held_c]
    return out


def serve_example_scenario(duration_s):
    """examples/serve_bittide.py's ``build_scenario`` (copied: the example
    imports the reference): a straggler onset, a thermal drift, a
    holdover window and a link outage, at fractions of the horizon."""
    from repro_torch.scenarios import (DriftRamp, FreqStep, LinkDrop,
                                       LinkRestore, NodeHoldover, NodeReset,
                                       Scenario)
    f = lambda x: x * duration_s
    return Scenario(events=(
        FreqStep(t=f(0.15), nodes=(3,), delta_ppm=-80_000.0),
        DriftRamp(t=f(0.35), t_end=f(0.55), nodes=(5,),
                  rate_ppm_per_s=60_000.0 / duration_s),
        NodeHoldover(t=f(0.45), nodes=(1,)),
        NodeReset(t=f(0.65), nodes=(1,)),
        LinkDrop(t=f(0.55), edges=(0,)),
        LinkRestore(t=f(0.75), edges=(0,)),
    ), name="serve-faults")


def serving_bench_scenario():
    """The ``serving_goodput`` lane's events
    (benchmarks/serving_bench.py, copied)."""
    from repro_torch.scenarios import (DriftRamp, FreqStep, NodeHoldover,
                                       NodeReset, Scenario)
    return Scenario(events=(
        FreqStep(t=5.0, nodes=(3,), delta_ppm=-80_000.0),
        DriftRamp(t=10.0, t_end=18.0, nodes=(5,), rate_ppm_per_s=4_000.0),
        NodeHoldover(t=14.0, nodes=(1,)),
        NodeReset(t=22.0, nodes=(1,)),
    ), name="bench-serve-straggler")


def pace_on_card(case, topo, speed, scenario, engine, duration_s):
    """One ``pace_workers`` call on the card (its default device), the
    fused kernel's count and the segment-sum run count set to 0 just
    before and read just after; the wall split by the flight recorder
    into the engine calls (its chunk spans) and the rest (the scenario's
    compile, segment prep, record copies).  On the fused lane every
    engine call is then held against the plain version at 0.0 error and
    replayed under CUDA events.  Returns (PacedEnsemble, row)."""
    import numpy as np
    import torch
    from repro_torch.core.frame_model import RUN_COUNT
    from repro_torch.kernels.bittide_step import bittide_fused
    from repro_torch.serve import pace_workers
    from repro_torch.telemetry import RunTrace
    tr = RunTrace(name=f"pace-{engine}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bittide_fused.launches = 0
    RUN_COUNT["segment-sum"] = 0
    t0 = time.perf_counter()
    with recorded_engine_calls() as calls:
        pe = pace_workers(topo, speed, scenario, kp=5e-3,
                          steps_per_second=10.0, duration_s=duration_s,
                          record_every=5, engine=engine, trace=tr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bittide_fused.launches
    runs = RUN_COUNT["segment-sum"]
    res = pe.result
    records = int(round(duration_s * 10.0)) // 5
    assert res.engine == engine, res.engine
    assert res.freq_ppm.shape == (2, records, topo.num_nodes)
    assert np.isfinite(res.freq_ppm).all() and np.isfinite(res.beta).all()
    chunk_s = sum(ev.dur for ev in tr.by_kind("chunk"))
    row = dict(phase="serve_pace", case=case, engine=engine,
               workers=topo.num_nodes, steps=int(round(duration_s * 10.0)),
               record_every=5, kp=5e-3, segments=len(res.compiled.segments),
               engine_calls=res.num_launches, fused_launches=launches,
               segment_sum_runs=runs, wall_s=wall, engine_calls_s=chunk_s,
               rest_of_wall_s=wall - chunk_s,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    if engine == "fused":
        assert launches == res.num_launches == len(calls) >= 1, row
        assert runs == 0, row
        held = hold_engine_calls(calls, 10**9, exact=True)["bittide_fused"]

        def replay():
            for a, _ in calls:
                args, kw = dense_call_args(a)
                bittide_fused(*args, **kw, lists=a["lists"])
        ms = cuda_ms(replay, 3)
        row.update(kernel_vs_plain=held, kernel_ms_all_calls=ms,
                   kernel_ms_per_call=ms / len(calls),
                   kernel_ms_note="CUDA events around one replay of every "
                                  "engine call's launch, back to back: the "
                                  "host's launch gaps included")
    else:
        assert launches == 0 and runs == res.num_launches, row
    del calls
    return pe, row


def serve_disciplines(case, engine, pe, reqs, cost, cfg, disc):
    """Serve ``reqs`` under each discipline of ``pe``: the wall of one
    serve, a second serve's fingerprint (equal), and a third with the
    per-tick witness (request conservation at every tick, every request
    completed, the same fingerprint).  Returns discipline -> row."""
    import dataclasses
    import numpy as np
    from repro_torch.serve import DISCIPLINES, serve
    rows = {}
    for d in DISCIPLINES:
        sched = pe.schedule(d, disc)
        t0 = time.perf_counter()
        res = serve(reqs, sched, cost, cfg)
        wall = time.perf_counter() - t0
        again = serve(reqs, sched, cost, cfg)
        ticks = serve(reqs, sched, cost,
                      dataclasses.replace(cfg, record_ticks=True))
        tt = ticks.ticks
        row = dict(phase="serve", case=case, engine=engine, discipline=d,
                   wall_s=wall, requests=res.num_requests,
                   completed=res.completed, ticks=res.num_ticks,
                   p50_s=res.p50_s, p99_s=res.p99_s, p999_s=res.p999_s,
                   goodput_tps=res.goodput_tps, offered_tps=res.offered_tps,
                   stall_s=res.stall_s,
                   slot_occupancy_mean=res.slot_occupancy_mean,
                   queue_peak=res.queue_peak,
                   fingerprint_equal=(res.fingerprint() == again.fingerprint()
                                      == ticks.fingerprint()),
                   conserved=bool(np.array_equal(
                       tt.admitted, tt.queued + tt.in_flight + tt.completed)
                       and tt.admitted[-1] == res.num_requests))
        emit(row)
        assert row["fingerprint_equal"] and row["conserved"], row
        assert res.completed == res.num_requests, row
        assert res.goodput_tps <= res.offered_tps + 1e-9, row
        rows[d] = row
    bt, bar = rows["bittide"], rows["barrier"]
    assert bt["goodput_tps"] >= bar["goodput_tps"], (bt, bar)
    assert bt["p99_s"] <= bar["p99_s"] + 1e-9, (bt, bar)
    return rows


def run_serve(dev):
    """Phase 11: the bittide-paced serving simulator and straggler pacing
    (see the module docstring)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import ring
    from repro_torch.core.frame_model import RUN_COUNT
    from repro_torch.ft import simulate_stragglers
    from repro_torch.serve import (ArrivalConfig, DisciplineConfig,
                                   ServeConfig, StepCostModel,
                                   generate_requests)
    topo = ring(8)
    speed = np.random.default_rng(7).uniform(-50_000, 50_000, 8)
    cost = StepCostModel.from_zoo("smollm-135m", decode_slots=8,
                                  hw_flops=1e12)
    disc = DisciplineConfig(queue_depth=16)
    out = dict(fused_launches=0, held=[], kernel_ms_per_call=[])

    # (a) examples/serve_bittide.py at its full default, on both lanes.
    reqs = generate_requests(ArrivalConfig(
        rate_rps=8.0, duration_s=60.0, diurnal_amp=0.4,
        diurnal_period_s=60.0, burst_rate_mult=3.0, burst_duration_s=3.0,
        num_bursts=2, prompt_mean=48.0, output_mean=24.0, seed=0))
    cfg = ServeConfig(8, 64, slo_s=30.0)
    paced = {}
    for engine in ("segment-sum", "fused"):
        pe, row = pace_on_card("example", topo, speed,
                               serve_example_scenario(60.0), engine, 60.0)
        rows = serve_disciplines("example", engine, pe, reqs, cost, cfg,
                                 disc)
        row["serve_wall_s"] = {d: r["wall_s"] for d, r in rows.items()}
        row["pace_share_of_wall"] = row["wall_s"] / (
            row["wall_s"] + sum(row["serve_wall_s"].values()))
        emit(row)
        paced[engine] = pe.result
        if engine == "fused":
            out["fused_launches"] += row["fused_launches"]
            out["held"].append(row["kernel_vs_plain"])
            out["kernel_ms_per_call"].append(row["kernel_ms_per_call"])
    fu, ss = paced["fused"], paced["segment-sum"]
    err = float(np.abs(fu.freq_ppm - ss.freq_ppm).max())
    bar = float32_floor_ppm(5e-3, int(topo.in_degree.max()), float(max(
        np.abs(fu.psi).max(), np.abs(ss.psi).max())))
    cross = dict(phase="serve_lanes", case="example",
                 freq_err_fused_vs_segment_sum_ppm=err,
                 float32_floor_bar_ppm=bar,
                 max_abs_freq_ppm=float(np.abs(ss.freq_ppm).max()),
                 beta_fused=list(fu.beta.shape),
                 beta_segment_sum=list(ss.beta.shape))
    emit(cross)
    assert err <= bar, cross

    # (b) the serving_goodput lane's configuration, on the fused lane.
    reqs = generate_requests(ArrivalConfig(
        rate_rps=6.0, duration_s=30.0, diurnal_amp=0.4,
        diurnal_period_s=30.0, burst_rate_mult=3.0, burst_duration_s=2.0,
        num_bursts=1, prompt_mean=48.0, output_mean=24.0, seed=0))
    pe, row = pace_on_card("serving_goodput", topo, speed,
                           serving_bench_scenario(), "fused", 30.0)
    rows = serve_disciplines("serving_goodput", "fused", pe, reqs, cost,
                             ServeConfig(8, 64, slo_s=15.0), disc)
    row["serve_wall_s"] = {d: r["wall_s"] for d, r in rows.items()}
    emit(row)
    out["fused_launches"] += row["fused_launches"]
    out["held"].append(row["kernel_vs_plain"])
    out["kernel_ms_per_call"].append(row["kernel_ms_per_call"])

    # (c) simulate_stragglers at tests/test_ft_straggler.py's case.
    for ki in (5e-5, 0.0):
        RUN_COUNT["segment-sum"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = simulate_stragglers(
            ring(4), np.array([50_000.0, -50_000.0, 0.0, 0.0]),
            queue_depth=512, steps_per_second=10.0, duration_s=100.0,
            kp=5e-3, ki=ki)
        torch.cuda.synchronize()
        row = dict(phase="stragglers", topology="ring4", ki=ki,
                   controller="pi" if ki else "proportional",
                   wall_s=time.perf_counter() - t0,
                   segment_sum_runs=RUN_COUNT["segment-sum"],
                   **dataclasses.asdict(rep))
        emit(row)
        assert row["segment_sum_runs"] == 2, row
        assert rep.controlled_queue_peak < rep.uncontrolled_queue_peak / 5
        assert rep.rate_spread_final < 1e-3 and rep.bounded, row
    return out


# Phase 12's bars: the reference's decode-vs-forward bar (rtol and atol;
# tests/test_models_modules.py, activations in bf16), the greedy margin
# past which the card's token must be the CPU's, and the f8 cache's bar
# (tests/test_perf_knobs.py: within 2 % of max |logit| of the bf16 cache).
LOGIT_TOL = 2e-2
GREEDY_MARGIN = 4e-2
F8_REL = 0.02
# The depth at which (b) holds decode to the forward's logits at the bar:
# the reference's own property is tested on 2-3 layers, and at full depth
# its own bf16 paths part by more (tests/test_torch_models_serving.py pins
# that on the reference: smollm-135m at its full 30 layers, mamba2-370m
# at 8 of its 48).  At full depth the greedy tokens must agree, and
# smollm's card parts by at most WITNESS_RATIO x the port on the CPU.
CHECK_LAYERS = 2
WITNESS_RATIO = 1.5


def matmul_flags() -> dict:
    import torch
    m = torch.backends.cuda.matmul
    return dict(allow_tf32=m.allow_tf32,
                allow_bf16_reduced_precision_reduction=(
                    m.allow_bf16_reduced_precision_reduction),
                allow_fp16_reduced_precision_reduction=(
                    m.allow_fp16_reduced_precision_reduction),
                cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                float32_matmul_precision=torch.get_float32_matmul_precision())


def model_batch(cfg, b, s, seed, dev):
    """A serving batch from ``default_rng(seed)``: tokens, plus the patch
    embeddings (vlm) or source embeddings (encdec) in bf16."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                                    dtype=torch.int32, device=dev)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.tensor(rng.normal(
            0, 1, (b, cfg.num_patch_tokens, cfg.d_model)),
            dtype=torch.float32, device=dev).to(torch.bfloat16)
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.tensor(rng.normal(
            0, 1, (b, s, cfg.d_model)), dtype=torch.float32,
            device=dev).to(torch.bfloat16)
    return batch


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def greedy(logits):
    import torch
    return logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)


def serve_greedy(zoo, params, batch, new_tokens):
    """examples/serve_decode.py's loop: prefill, then widen the caches by
    one slot and decode the greedy token, ``new_tokens - 1`` times.
    Returns the (B, new_tokens) int32 tokens, whether every logit was
    finite, the CUDA-event ms of the prefill and of the decode loop, and
    the cache bytes each decode step read."""
    import torch
    from repro_torch.models import widen_caches
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    logits, caches = zoo.prefill(params, batch)
    ev[1].record()
    finite = torch.isfinite(logits).all()
    tok = greedy(logits)
    out, cache_bytes = [tok], []
    for _ in range(new_tokens - 1):
        caches = widen_caches(caches)
        cache_bytes.append(tree_bytes(caches))
        logits, caches = zoo.decode(params, caches, {"tokens": tok})
        finite &= torch.isfinite(logits).all()
        tok = greedy(logits)
        out.append(tok)
    ev[2].record()
    torch.cuda.synchronize()
    return dict(tokens=torch.cat(out, dim=1), finite=bool(finite),
                prefill_ms=ev[0].elapsed_time(ev[1]),
                decode_ms=ev[1].elapsed_time(ev[2]),
                cache_bytes=cache_bytes)


def device_busy(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler`` (CPU and CUDA): its wall
    (ending in a synchronize), the device's busy time (the kernels' and
    copies' own time: one stream, so they do not overlap), the share of
    the wall the device was idle, the device operations launched, and
    the five device operations that took longest (name, ms, count).
    ``busy_ms`` is None where the trace shows no device time."""
    import time
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    return dict(wall_ms=wall, busy_ms=busy or None,
                idle_share=(1.0 - busy / wall) if busy else None,
                device_ops=sum(e.count for e in rows),
                top=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
                     for e in rows[:5]])


def decode_vs_forward(zoo, params, tokens) -> dict:
    """prefill(S-1) + decode(1) against prefill(S)'s last logits: the
    largest error, the largest excess over the bar (≤ 0 passes), the share
    of logits over it, and the sequences whose forward top-1 / top-2
    margin exceeds ``GREEDY_MARGIN`` with the greedy token decode agrees
    on."""
    from repro_torch.models import widen_caches
    full, _ = zoo.prefill(params, {"tokens": tokens})
    _, caches = zoo.prefill(params, {"tokens": tokens[:, :-1]})
    dec, _ = zoo.decode(params, widen_caches(caches),
                        {"tokens": tokens[:, -1:]})
    err = (dec - full).abs()
    excess = err - (LOGIT_TOL + LOGIT_TOL * full.abs())
    top2 = full[:, -1].topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > GREEDY_MARGIN
    same = (greedy(dec) == greedy(full))[:, 0]
    return dict(err=float(err.max()), excess=float(excess.max()),
                over=float((excess > 0).float().mean()),
                sure=int(sure.sum()), sure_equal=int(same[sure].sum()))


def first_layers(params, n):
    """The parameters of a stacked-layer model cut to its first n layers."""
    def cut(t):
        return {k: cut(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[:n]
    return dict(params, layers=cut(params["layers"]))


def serve_full_width(name, dev, smi, b, s, new_tokens, check_s,
                     cpu_witness=False):
    """Phase 12 (a) / (c): one architecture at full width and depth on
    random weights from a seeded generator on the card.  With
    ``cpu_witness``, (b) at full depth also holds the card's parting on
    the first sequence within ``WITNESS_RATIO`` x the CPU's on the same
    weights and tokens."""
    import dataclasses
    import time
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import ModelZoo, materialize, widen_caches
    cfg = get_config(name)
    zoo = ModelZoo(cfg)
    t0 = time.perf_counter()
    params = materialize(zoo.param_defs(),
                         torch.Generator(device=dev).manual_seed(0),
                         torch.float32, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = tree_bytes(params)
    n_params = param_bytes // 4           # float32
    batch = model_batch(cfg, b, s, 0, dev)
    with torch.inference_mode():
        serve_greedy(zoo, params, batch, 2)             # warm-up
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = serve_greedy(zoo, params, batch, new_tokens)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        # the device's busy and idle time under the profiler: one prefill,
        # then four decode steps
        prof_prefill = device_busy(lambda: zoo.prefill(params, batch))
        _, caches = zoo.prefill(params, batch)
        tok = run["tokens"][:, :1]

        def four_steps():
            nonlocal caches
            for _ in range(4):
                logits, caches = zoo.decode(params, widen_caches(caches),
                                            {"tokens": tok})
        prof_decode = device_busy(four_steps)
        del caches
        # (b): at full width and depth, and with the depth cut to the
        # reference's tested depth (its reduced configs: 2-3 layers), on
        # the same weights
        check = decode_vs_forward(zoo, params, batch["tokens"][:, :check_s])
        cut = ModelZoo(dataclasses.replace(cfg, num_layers=CHECK_LAYERS))
        check_cut = decode_vs_forward(cut, first_layers(params, CHECK_LAYERS),
                                      batch["tokens"][:, :check_s])
        witness = None
        if cpu_witness:
            one = batch["tokens"][:1, :check_s]
            on_card = decode_vs_forward(zoo, params, one)
            on_cpu = decode_vs_forward(zoo, tree_to(params, "cpu"),
                                       one.cpu())
            witness = dict(sequences=1, tokens=check_s, card=on_card,
                           cpu=on_cpu, ratio=on_card["err"] / on_cpu["err"],
                           bar=WITNESS_RATIO)
    toks = run["tokens"]
    steps = new_tokens - 1
    # Two bytes bounds for a decode step.  The arithmetic as written:
    # every float32 parameter it reads in full (all but an untied
    # embedding table, of which it gathers B rows) read as stored, its
    # bf16 copy written by the call's cast and read back by the matmul
    # (4 + 2 + 2 bytes per parameter), and the caches read (their mean
    # over the steps).  The function's own: the same parameters and
    # caches, each read once (4 bytes per parameter).
    read_params = n_params - (0 if cfg.tie_embeddings
                              else params["embed"].numel())
    cache_mean = sum(run["cache_bytes"]) / steps
    bound_bytes = 8 * read_params + cache_mean
    own_bytes = 4 * read_params + cache_mean
    row = dict(
        phase="models", part=name, nvidia_smi=smi, batch=b, prompt=s,
        new_tokens=new_tokens, layers=cfg.num_layers, d_model=cfg.d_model,
        params=n_params, param_bytes=param_bytes, init_s=init_s,
        prefill_ms=run["prefill_ms"],
        prefill_tokens_per_s=b * s / run["prefill_ms"] * 1e3,
        decode_ms_per_step=run["decode_ms"] / steps,
        decode_tokens_per_s=b * steps / run["decode_ms"] * 1e3,
        serve_wall_s=wall, peak_memory_bytes=peak,
        decode_cache_bytes_mean=cache_mean,
        decode_bound_bytes=bound_bytes,
        decode_bound_ms=bound_bytes / PEAK_BYTES_PER_S * 1e3,
        decode_params_read=read_params,
        decode_bound_note=("per step, the arithmetic as written: the f32 "
                           "parameters read in full (an untied embedding "
                           "table is gathered, not read) + their bf16 cast "
                           "written and read + the caches read, over "
                           "3.35 TB/s"),
        decode_own_bound_bytes=own_bytes,
        decode_own_bound_ms=own_bytes / PEAK_BYTES_PER_S * 1e3,
        decode_own_bound_note=("per step, the function's own: the same f32 "
                               "parameters and the caches, each read once, "
                               "over 3.35 TB/s"),
        tokens_shape=list(toks.shape), tokens_dtype=str(toks.dtype),
        finite=run["finite"], decode_vs_forward_s=check_s,
        profile_prefill=prof_prefill,
        profile_4_decode_steps=prof_decode,
        decode_vs_forward=check,
        decode_vs_forward_cut=dict(check_cut, layers=CHECK_LAYERS),
        decode_vs_forward_cpu_witness=witness)
    row["decode_bound_share"] = row["decode_bound_ms"] / row[
        "decode_ms_per_step"]
    row["decode_own_bound_share"] = row["decode_own_bound_ms"] / row[
        "decode_ms_per_step"]
    emit(row)
    assert row["finite"], name
    assert tuple(toks.shape) == (b, new_tokens) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    assert check["sure_equal"] == check["sure"], (name, check)
    assert check_cut["excess"] <= 0.0, (name, "decode != forward", check_cut)
    assert check_cut["sure_equal"] == check_cut["sure"], (name, check_cut)
    if witness is not None:
        assert witness["ratio"] <= WITNESS_RATIO, (name, witness)
    return row, zoo, params, batch


def f8_cache_check(zoo, params, tokens) -> float:
    """Decode with the K/V cache in float8_e4m3fn against the bf16 cache:
    the largest difference over max |logit|."""
    from repro_torch.models import widen_caches
    from repro_torch.models.transformer import to_kv_dtype
    import torch
    _, caches = zoo.prefill(params, {"tokens": tokens[:, :-1]})
    kv = widen_caches(caches)["kv"]
    dec = {"tokens": tokens[:, -1:]}
    base, _ = zoo.decode(params, {"kv": kv}, dec)
    got, new = zoo.decode(params, {"kv": to_kv_dtype(kv, torch.float8_e4m3fn)},
                          dec)
    assert new["kv"].dtype == torch.float8_e4m3fn
    return float((got - base).abs().max() / base.abs().max())


def card_vs_cpu(name, dev, b=2, s=64, steps=4) -> dict:
    """Phase 12 (d): one architecture at ``.reduced()``, the same weights
    (drawn on the CPU) on the card and on the CPU: prefill and ``steps``
    decode steps fed the CPU's greedy tokens.  Logits within the bar; the
    card's greedy token equals the CPU's wherever the CPU's top-1 / top-2
    margin exceeds ``GREEDY_MARGIN``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import ModelZoo, materialize, widen_caches
    cfg = get_config(name).reduced()
    zoo = ModelZoo(cfg)
    p_cpu = materialize(zoo.param_defs(), torch.Generator().manual_seed(0),
                        torch.float32, device="cpu")
    p_dev = tree_to(p_cpu, dev)
    b_cpu = model_batch(cfg, b, s, 1, "cpu")
    b_dev = tree_to(b_cpu, dev)
    worst = dict(name=name, excess=-1.0, err=0.0, compared=0, sure=0,
                 tokens_equal=0)

    def hold(lc, ld):
        ld = ld.cpu()
        err = (ld - lc).abs()
        worst["excess"] = max(worst["excess"], float(
            (err - (LOGIT_TOL + LOGIT_TOL * lc.abs())).max()))
        worst["err"] = max(worst["err"], float(err.max()))
        top2 = lc[:, -1].topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > GREEDY_MARGIN
        eq = greedy(lc) == greedy(ld)
        worst["compared"] += b
        worst["sure"] += int(sure.sum())
        worst["tokens_equal"] += int(eq[sure].sum())

    with torch.inference_mode():
        lc, cc = zoo.prefill(p_cpu, b_cpu)
        ld, cd = zoo.prefill(p_dev, b_dev)
        hold(lc, ld)
        for _ in range(steps):
            tok = greedy(lc)
            lc, cc = zoo.decode(p_cpu, widen_caches(cc), {"tokens": tok})
            ld, cd = zoo.decode(p_dev, widen_caches(cd),
                                {"tokens": tok.to(dev)})
            hold(lc, ld)
    return worst


def run_models(dev, smi):
    """Phase 12: model serving on the card (see the module docstring)."""
    import torch
    from repro_torch.configs import ARCH_NAMES
    emit(dict(phase="models", part="matmul_flags", nvidia_smi=smi,
              **matmul_flags()))
    out = {}
    # (a) + (b): smollm-135m at full width and depth
    row, zoo, params, batch = serve_full_width(
        "smollm-135m", dev, smi, b=8, s=2048, new_tokens=32, check_s=1024,
        cpu_witness=True)
    with torch.inference_mode():
        row["f8_cache_rel"] = f8_cache_check(zoo, params,
                                             batch["tokens"][:, :1024])
    emit(dict(phase="models", part="smollm-135m f8 cache", nvidia_smi=smi,
              f8_cache_rel=row["f8_cache_rel"], bar=F8_REL))
    assert row["f8_cache_rel"] < F8_REL
    out["smollm"] = row
    del zoo, params, batch
    # (c): mamba2-370m at full width and depth
    out["mamba2"], *_ = serve_full_width(
        "mamba2-370m", dev, smi, b=4, s=1024, new_tokens=16, check_s=1024)
    # (d): every architecture, reduced, the card against the CPU
    rows = [card_vs_cpu(name, dev) for name in ARCH_NAMES]
    emit(dict(phase="models", part="card_vs_cpu", nvidia_smi=smi,
              bar=dict(rtol=LOGIT_TOL, atol=LOGIT_TOL,
                       greedy_margin=GREEDY_MARGIN), rows=rows))
    for r in rows:
        assert r["excess"] <= 0.0, r
        assert r["tokens_equal"] == r["sure"], r
    out["card_vs_cpu"] = rows
    return out


# Phase 13's bars: tests/test_torch_train_zoo.py's (tests/test_perf_knobs.py's
# loss and gradient bars), and its AdamW bar (f32 ulps of each leaf's max
# |p|; tests/test_torch_train_modules.py).
TRAIN_LOSS_REL = 2e-3
TRAIN_GRAD_RTOL = 5e-2
TRAIN_GRAD_ATOL = 5e-4
ADAMW_F32_ULPS = 2
# H100 SXM dense bf16 tensor-core peak, without sparsity (NVIDIA data
# sheet): the yardstick of phase 13's 6·N·D share.
PEAK_BF16_FLOPS = 989e12


def train_batch(cfg, b, s, seed, dev):
    """``model_batch`` plus ``labels`` (int32) from ``default_rng(seed +
    1)``."""
    import numpy as np
    import torch
    batch = model_batch(cfg, b, s, seed, dev)
    batch["labels"] = torch.tensor(
        np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (b, s)),
        dtype=torch.int32, device=dev)
    return batch


def bit_equal(a, b) -> bool:
    """Whether two tensors hold the same bits (0.0 and -0.0 apart)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[a.element_size()]
        a, b = a.view(ints), b.view(ints)
    return torch.equal(a, b)


def int8_scale_ties(n=4096, seed=0):
    """An f32 gradient on which a wrong int8 scale shows: its max ``m``
    has ``fl(m · fl(1/127)) != fl(m / 127)`` (a product with the
    divisor's reciprocal, as CUDA computes a division by a Python
    scalar, against the quotient the reference takes), and every other
    element lies at a half of the int8 grid of one of the two scales,
    so that ``round(x / scale)`` parts between them.  Returns (x, the
    quotient, the product, how many elements' int8 values part), all
    found with numpy on the host."""
    import numpy as np
    rng = np.random.default_rng(seed)
    inv = np.float32(1) / np.float32(127)
    for m in rng.uniform(0.5, 2.0, 1000).astype(np.float32):
        quot, prod = m / np.float32(127), m * inv
        if quot != prod:
            break
    k = rng.integers(-126, 126, n).astype(np.float32)
    s = np.where(rng.random(n) < 0.5, quot, prod).astype(np.float32)
    x = (k + np.float32(0.5)) * s
    x[0] = m
    parted = np.round(x / quot) != np.round(x / prod)
    return x, quot, prod, int(parted.sum())


def train_loop(zoo, params, opt, opt_state, data, steps, dev, ckpt=None,
               ckpt_step=None):
    """examples/train_bittide_cluster.py's loop: ``value_and_grad`` of
    ``train_loss``, then ``adamw_update`` (no ``lr_schedule``).  Returns
    the final params and state, the losses and gradient norms (host
    floats), each step's CUDA-event ms and host wall, and, with ``ckpt``
    (a ``CheckpointManager``), the state saved asynchronously as step
    ``ckpt_step`` (after that many updates) and a host copy of it."""
    import torch
    from repro_torch._tree import tree_map
    from repro_torch.launch import value_and_grad
    from repro_torch.optim import adamw_update
    loss_and_grads = value_and_grad(zoo.train_loss)
    losses, norms, events, walls, saved = [], [], [], [], None
    for step in range(steps):
        batch = data.batch(step, device=dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        loss, grads = loss_and_grads(params, batch)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params, opt)
        ev[1].record()
        walls.append(time.perf_counter() - t0)
        del grads
        losses.append(loss)
        norms.append(gnorm)
        events.append(ev)
        if ckpt is not None and step + 1 == ckpt_step:
            state = {"params": params, "opt": opt_state}
            ckpt.save(ckpt_step, state, blocking=False)
            saved = tree_map(lambda t: t.detach().cpu(), state)
    torch.cuda.synchronize()
    return dict(params=params, opt_state=opt_state,
                losses=[float(x) for x in losses],
                grad_norms=[float(x) for x in norms],
                step_ms=[a.elapsed_time(b) for a, b in events],
                step_wall_s=walls, saved=saved)


def train_full_width(name, dev, smi, b, s, steps, time_from, ckpt_dir=None,
                     ckpt_step=None):
    """Phase 13 (a) / (b): ``name`` at full width and depth on random f32
    weights from a seeded generator, AdamW(lr 3e-3, weight decay 0.01),
    ``steps`` steps on ``SyntheticPipeline(DataConfig(V, s, b, seed=0))``;
    with ``ckpt_dir``, an async checkpoint of step ``ckpt_step`` restored
    into a fresh template and checked bit for bit, leaf by leaf and by the
    forward loss it gives."""
    import shutil
    import numpy as np
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.checkpoint import CheckpointManager, restore
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.launch import value_and_grad
    from repro_torch.models import ModelZoo, materialize
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    cfg = get_config(name)
    zoo = ModelZoo(cfg)
    params = materialize(zoo.param_defs(),
                         torch.Generator(device=dev).manual_seed(0),
                         torch.float32, device=dev)
    opt = AdamWConfig(lr=3e-3, weight_decay=0.01)
    opt_state = adamw_init(params, opt)
    data = SyntheticPipeline(DataConfig(cfg.vocab_size, s, b, seed=0))
    mgr = None
    if ckpt_dir is not None:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        mgr = CheckpointManager(str(ckpt_dir), keep=2)
    n_params = tree_bytes(params) // 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train_loop(zoo, params, opt, opt_state, data, steps, dev, mgr,
                     ckpt_step)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    params, opt_state = run["params"], run["opt_state"]

    # the device's busy and idle time over three more steps
    loss_and_grads = value_and_grad(zoo.train_loss)
    more = [data.batch(steps + i, device=dev) for i in range(3)]

    def three_steps():
        p, st = params, opt_state
        for batch in more:
            _, grads = loss_and_grads(p, batch)
            p, st, _ = adamw_update(grads, st, p, opt)
    prof = device_busy(three_steps)

    step_ms = float(np.median(run["step_ms"][time_from:]))
    flops = zoo.model_flops(ShapeSpec("train", "train", s, b))
    losses = run["losses"]
    row = dict(
        phase="train", part=name, nvidia_smi=smi, batch=b, seq=s,
        steps=steps, layers=cfg.num_layers, d_model=cfg.d_model,
        vocab=cfg.vocab_size, params=n_params,
        optimizer=dict(lr=opt.lr, weight_decay=opt.weight_decay,
                       moments=opt.moment_dtype),
        step_ms_median=step_ms, step_ms_from=time_from,
        step_ms_first=run["step_ms"][0],
        step_wall_s_median=float(np.median(run["step_wall_s"][time_from:])),
        tokens_per_s=b * s / step_ms * 1e3, train_wall_s=wall,
        peak_memory_bytes=peak,
        model_flops_per_step=flops,
        model_flops_share_of_bf16_peak=flops / (step_ms / 1e3)
        / PEAK_BF16_FLOPS,
        peak_note="6·N·D per step over the step's median CUDA-event time, "
                  "against 989 TFLOP/s (H100 SXM dense bf16, NVIDIA data "
                  "sheet) at the card's power limit above",
        profile_3_steps=prof,
        device_ops_per_step=prof["device_ops"] / 3,
        losses_every_10=losses[::10] + [losses[-1]],
        grad_norms_every_10=run["grad_norms"][::10],
        loss_first10_mean=float(np.mean(losses[:10])),
        loss_last10_mean=float(np.mean(losses[-10:])))
    assert all(np.isfinite(losses)), (name, losses)
    if mgr is not None:
        mgr.wait()
        saved = run["saved"]
        template = {"params": materialize(
            zoo.param_defs(), torch.Generator(device=dev).manual_seed(1),
            torch.float32, device=dev), "opt": adamw_init(params, opt)}
        t0 = time.perf_counter()
        got = restore(str(ckpt_dir), ckpt_step, template, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        pairs = [(a.cpu(), b) for a, b in zip(tree_leaves(got),
                                              tree_leaves(saved))]
        with torch.no_grad():
            loss = float(zoo.train_loss(got["params"],
                                        data.batch(ckpt_step, device=dev)))
        row["checkpoint"] = dict(
            step=ckpt_step, kept=sorted(p.name for p in ckpt_dir.iterdir()
                                        if p.name.startswith("step_")),
            leaves=len(pairs),
            leaves_bit_identical=sum(bit_equal(a, b) for a, b in pairs),
            restore_s=restore_s, resumed_loss=loss,
            uninterrupted_loss=losses[ckpt_step],
            loss_bit_identical=loss == losses[ckpt_step])
    emit(row)
    if mgr is not None:
        ck = row["checkpoint"]
        assert ck["leaves_bit_identical"] == ck["leaves"], ck
        assert ck["loss_bit_identical"], ck
    return row


def train_card_vs_cpu(name, dev, b=2, s=64) -> dict:
    """Phase 13 (c): one architecture at ``.reduced()``, the same weights
    (drawn on the CPU) and batch on the card and the CPU: ``train_loss``
    and its gradients, then one ``adamw_update`` on each device given the
    CPU's gradients.  The worst excess over each bar (≤ 0 passes).  A
    gradient leaf over the elementwise bar (a bf16 sum that cancels, as
    the SSM convolution's: on the CPU the reference's own jitted and
    op-by-op gradients part past that bar there) is held at the bar taken
    at its largest |gradient| and listed in ``leaf_scale``
    (tests/test_torch_train_zoo.py holds the CPU to the reference so)."""
    import numpy as np
    import torch
    from repro_torch._tree import tree_flatten_with_path
    from repro_torch.configs import get_config
    from repro_torch.launch import value_and_grad
    from repro_torch.models import ModelZoo, materialize
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    cfg = get_config(name).reduced()
    zoo = ModelZoo(cfg)
    p_cpu = materialize(zoo.param_defs(), torch.Generator().manual_seed(0),
                        torch.float32, device="cpu")
    b_cpu = train_batch(cfg, b, s, 1, "cpu")
    vg = value_and_grad(zoo.train_loss)
    loss_c, g_c = vg(p_cpu, b_cpu)
    loss_d, g_d = vg(tree_to(p_cpu, dev), tree_to(b_cpu, dev))
    row = dict(name=name, loss_cpu=float(loss_c), loss_card=float(loss_d),
               loss_rel=abs(float(loss_d) - float(loss_c)) / abs(
                   float(loss_c)),
               grad_excess=-1.0, grad_worst_leaf=None, leaf_scale=[],
               adamw_excess=-1.0, adamw_worst_leaf=None)
    for (path, gc), (_, gd) in zip(tree_flatten_with_path(g_c),
                                   tree_flatten_with_path(g_d)):
        gc, gd = gc.float(), gd.float().cpu()
        diff = (gd - gc).abs()
        ex = float((diff - (TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL
                            * gc.abs())).max())
        if ex > 0.0:
            ex = float(diff.max()) - (TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL
                                      * float(gc.abs().max()))
            row["leaf_scale"].append(dict(
                leaf="/".join(path), err=float(diff.max()),
                max_abs=float(gc.abs().max()), excess=ex))
        if not np.isfinite(ex) or ex > row["grad_excess"]:
            row["grad_excess"], row["grad_worst_leaf"] = ex, "/".join(path)
    opt = AdamWConfig(moment_dtype=cfg.opt_moment_dtype)
    st = adamw_init(p_cpu, opt)
    new_c, _, n_c = adamw_update(g_c, st, p_cpu, opt)
    new_d, _, n_d = adamw_update(tree_to(g_c, dev), tree_to(st, dev),
                                 tree_to(p_cpu, dev), opt)
    row["adamw_grad_norm_cpu"], row["adamw_grad_norm_card"] = (
        float(n_c), float(n_d))
    for (path, pc), (_, pd) in zip(tree_flatten_with_path(new_c),
                                   tree_flatten_with_path(new_d)):
        bar = ADAMW_F32_ULPS * float(np.spacing(np.float32(
            pc.abs().max())))
        ex = float((pd.cpu() - pc).abs().max()) - bar
        if not np.isfinite(ex) or ex > row["adamw_excess"]:
            row["adamw_excess"], row["adamw_worst_leaf"] = ex, "/".join(path)
    return row


def run_train(dev, smi):
    """Phase 13: the training path on the card (see the module
    docstring)."""
    from repro_torch.configs import ARCH_NAMES
    t_phase = time.perf_counter()
    # (a) smollm-135m at full width and depth: the training example's step
    # (its sync, ring schedule and stragglers run in phase 16)
    out = {}
    out["smollm"] = train_full_width(
        "smollm-135m", dev, smi, b=8, s=256, steps=60, time_from=10,
        ckpt_dir=ROOT / "build" / "phase13_ckpt", ckpt_step=50)
    sm = out["smollm"]
    assert sm["loss_last10_mean"] < sm["loss_first10_mean"], sm
    # (b) mamba2-370m: the SSD scan's backward at full width and depth
    out["mamba2"] = train_full_width("mamba2-370m", dev, smi, b=4, s=256,
                                     steps=5, time_from=1)
    # (c) every architecture, reduced: the card against the CPU
    rows = [train_card_vs_cpu(name, dev) for name in ARCH_NAMES]
    emit(dict(phase="train", part="card_vs_cpu", nvidia_smi=smi,
              bars=dict(loss_rel=TRAIN_LOSS_REL, grad_rtol=TRAIN_GRAD_RTOL,
                        grad_atol=TRAIN_GRAD_ATOL,
                        adamw_f32_ulps=ADAMW_F32_ULPS), rows=rows))
    for r in rows:
        assert r["loss_rel"] <= TRAIN_LOSS_REL, r
        assert r["grad_excess"] <= 0.0, r
        assert r["adamw_excess"] <= 0.0, r
    out["card_vs_cpu"] = rows
    emit(dict(phase="train", part="total",
              seconds=time.perf_counter() - t_phase))
    return out


def mesh_state_bits(mesh_state, plain_state) -> list:
    """The leaves (by path) of a state on a mesh whose full arrays differ
    in any bit from a plain state's."""
    from repro_torch._tree import tree_flatten_with_path, tree_leaves
    return ["/".join(path) for (path, a), b in zip(
        tree_flatten_with_path(mesh_state), tree_leaves(plain_state))
        if not bit_equal(a.full_tensor(), b)]


def split_layout(cfg, mesh, params) -> dict:
    """What the mesh step splits over "model" (``models.parallel``)."""
    from repro_torch.launch.train import _tensor_parallel
    tp, _ = _tensor_parallel(cfg, mesh, params)
    return None if tp is None else dict(model=tp.size, attn=tp.attn,
                                        mlp=tp.mlp, embed=tp.embed,
                                        head=tp.head, experts=tp.experts,
                                        shared=tp.shared, dense=tp.dense,
                                        ssm=tp.ssm)


def cache_layout(caches) -> str:
    """The placements of a tree of cache DTensors, leaf by leaf."""
    from repro_torch._tree import tree_flatten_with_path
    return "; ".join(f"{'/'.join(path)} {tuple(t.placements)}"
                     for path, t in tree_flatten_with_path(caches))


def split_prefill_bits(cfg, p_mesh, p_plain, batch, dev, reps=3) -> dict:
    """``make_prefill_step`` on a mesh state against ``ModelZoo.prefill``
    on the plain state, on ``batch`` (tokens, and the VLM's patch
    embeddings): the logits and K/V caches bit for bit, and the
    CUDA-event ms of both (the median of ``reps`` calls each, in
    turns)."""
    import numpy as np
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.launch import make_prefill_step
    from repro_torch.models import ModelZoo
    split, plain = make_prefill_step(cfg), ModelZoo(cfg).prefill
    times = {"split": [], "plain": []}

    def timed_call(fn, params):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        with torch.inference_mode():
            out = fn(params, batch)
        ev[1].record()
        torch.cuda.synchronize()
        return out, ev[0].elapsed_time(ev[1])

    for _ in range(reps):
        (got_l, got_c), ms = timed_call(split, p_mesh)
        times["split"].append(ms)
        (want_l, want_c), ms = timed_call(plain, p_plain)
        times["plain"].append(ms)
    diff = [] if bit_equal(got_l.full_tensor(), want_l) else ["logits"]
    diff += [f"cache{i}" for i, (a, b) in enumerate(zip(
        tree_leaves(got_c), tree_leaves(want_c)))
        if not bit_equal(a.full_tensor(), b)]
    return dict(batch=list(batch["tokens"].shape), bits_differ=diff,
                split_ms=times["split"], plain_ms=times["plain"],
                split_ms_median=float(np.median(times["split"])),
                plain_ms_median=float(np.median(times["plain"])))


def reduced_split_bits(mesh, dev, steps=3) -> dict:
    """Reduced llama3-8b (untied: the vocabulary-parallel loss, the
    logits gathered over the vocabulary) on ``mesh``: ``steps`` split
    train steps and a split prefill against the plain ones, bit for
    bit."""
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.launch import init_train_state, make_train_step
    cfg = get_config("llama3-8b").reduced()
    p_m, o_m = init_train_state(cfg, mesh,
                                torch.Generator(device=dev).manual_seed(0))
    p, o = init_train_state(cfg, None,
                            torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    data = SyntheticPipeline(DataConfig(cfg.vocab_size, 64, 2, seed=5))
    step = make_train_step(cfg)
    diff = []
    for n in range(steps):
        batch = data.batch(n, device=dev)
        p_m, o_m, mm = step(p_m, o_m, batch, n)
        p, o, m = step(p, o, batch, n)
        if not (bit_equal(mm["loss"], m["loss"])
                and bit_equal(mm["grad_norm"], m["grad_norm"])):
            diff.append(f"step{n}/metrics")
        diff += [f"step{n}/{i}" for i, (a, b) in enumerate(zip(
            tree_leaves({"p": p_m, "o": o_m}), tree_leaves({"p": p, "o": o})))
            if not bit_equal(a.full_tensor(), b)]
    pre = split_prefill_bits(cfg, p_m, p, {"tokens": batch["tokens"]}, dev,
                             reps=1)
    return dict(steps=steps, layout=split_layout(cfg, mesh, p_m),
                bits_differ=diff + pre["bits_differ"])


def split_decode_bits(cfg, p_mesh, p_plain, batch, dev, steps=4) -> dict:
    """``make_prefill_step`` on ``batch`` (tokens, and the VLM's patch
    embeddings) then ``steps`` greedy ``make_decode_step``
    calls on a mesh state (``widen_mesh_caches`` between them; the
    caches placed as ``cache_defs`` lays them out: K/V (the hybrid's
    ``shared_kv`` too) split on the sequence over "model", the
    encoder-decoder's ``cross_kv`` on the source's, SSM states on
    their heads) against ``ModelZoo.prefill`` then ``.decode`` on
    ``widen_caches`` on the plain state, both fed the plain chain's greedy
    tokens: the logits and caches bit for bit after the prefill and
    every step, and the CUDA-event ms of each decode call (the widen
    outside it; after one untimed call of each)."""
    import numpy as np
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.launch import (make_decode_step, make_prefill_step,
                                    widen_mesh_caches)
    from repro_torch.models import ModelZoo, widen_caches
    zoo = ModelZoo(cfg)
    decode = make_decode_step(cfg)
    times = {"split": [], "plain": []}

    def timed_call(fn, *args):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        with torch.inference_mode():
            out = fn(*args)
        ev[1].record()
        torch.cuda.synchronize()
        return out, ev[0].elapsed_time(ev[1])

    def differ(tag, got_l, got_c, want_l, want_c):
        diff = [] if bit_equal(got_l.full_tensor(), want_l) else [
            f"{tag}/logits"]
        return diff + [f"{tag}/cache{i}" for i, (a, b) in enumerate(zip(
            tree_leaves(got_c), tree_leaves(want_c)))
            if not bit_equal(a.full_tensor(), b)]

    with torch.inference_mode():
        got_l, got_c = make_prefill_step(cfg)(p_mesh, batch)
        want_l, want_c = zoo.prefill(p_plain, batch)
    diff = differ("prefill", got_l, got_c, want_l, want_c)
    placements = [cache_layout(got_c)]
    with torch.inference_mode():   # one untimed call of each, to warm up
        tok = want_l.argmax(-1).to(torch.int32)
        decode(p_mesh, widen_mesh_caches(cfg, got_c), {"tokens": tok})
        zoo.decode(p_plain, widen_caches(want_c), {"tokens": tok})
    for n in range(steps):
        tok = want_l.argmax(-1).to(torch.int32)
        with torch.inference_mode():
            got_in = widen_mesh_caches(cfg, got_c)
            want_in = widen_caches(want_c)
        (got_l, got_c), ms = timed_call(decode, p_mesh, got_in,
                                        {"tokens": tok})
        times["split"].append(ms)
        (want_l, want_c), ms = timed_call(zoo.decode, p_plain, want_in,
                                          {"tokens": tok})
        times["plain"].append(ms)
        diff += differ(f"step{n}", got_l, got_c, want_l, want_c)
        placements.append(cache_layout(got_c))
    return dict(batch=list(batch["tokens"].shape), steps=steps,
                bits_differ=diff,
                cache_seq=next((int(want_c[k].shape[3])
                                for k in ("kv", "shared_kv") if k in want_c),
                               None),
                cross_seq=(int(want_c["cross_kv"].shape[3])
                           if "cross_kv" in want_c else None),
                cache_placements=placements,
                split_ms=times["split"], plain_ms=times["plain"],
                split_ms_median=float(np.median(times["split"])),
                plain_ms_median=float(np.median(times["plain"])))


def split_bits_at_width(cfg, mesh, dev, batch, serve, decode_steps) -> dict:
    """One split train step on ``batch``, the split prefill on ``serve``
    (tokens, and the VLM's patch embeddings or the encoder-decoder's
    source frames, which the train step's ``batch`` carries too) and
    ``decode_steps`` split decode steps of ``cfg`` on ``mesh``,
    seeded random weights, against the plain calls from the same state,
    bit for bit.  The plain state is the mesh leaves' local tensors (one
    rank's shards are whole: the same storage); the mesh step's new state
    goes to the host before the plain step runs, so that the card never
    holds two new states."""
    import torch
    from repro_torch._tree import tree_flatten_with_path, tree_leaves, \
        tree_map
    from repro_torch.launch import init_train_state, make_train_step
    p_m, o_m = init_train_state(cfg, mesh,
                                torch.Generator(device=dev).manual_seed(0))
    local = lambda t: t.to_local()
    p, o = tree_map(local, p_m), tree_map(local, o_m)
    step = make_train_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    (new_m, ms_m) = timed(lambda: step(p_m, o_m, batch, 0))
    host = tree_map(lambda t: t.to_local().cpu(),
                    {"p": new_m[0], "o": new_m[1]})
    loss_m = new_m[2]["loss"]
    del new_m
    (new_p, ms_p) = timed(lambda: step(p, o, batch, 0))
    diff = [] if bit_equal(loss_m, new_p[2]["loss"]) else ["train/loss"]
    diff += ["train/" + "/".join(path) for (path, a), b_ in zip(
        tree_flatten_with_path(host),
        tree_leaves({"p": new_p[0], "o": new_p[1]}))
        if not bit_equal(a, b_.cpu())]
    peak = torch.cuda.max_memory_allocated()
    del new_p, host
    pre = split_prefill_bits(cfg, p_m, p, serve, dev, reps=1)
    dec = split_decode_bits(cfg, p_m, p, serve, dev, steps=decode_steps)
    return dict(arch=cfg.name,
                layers=(dict(encoder=cfg.encoder_layers,
                             decoder=cfg.decoder_layers)
                        if cfg.family == "encdec" else cfg.num_layers),
                batch=list(batch["tokens"].shape),
                params=sum(t.numel() for t in tree_leaves(p)),
                layout=split_layout(cfg, mesh, p_m),
                train_step_ms=dict(split=ms_m * 1e3, plain=ms_p * 1e3),
                train_peak_memory_bytes=peak, loss=float(loss_m),
                prefill_ms=dict(split=pre["split_ms_median"],
                                plain=pre["plain_ms_median"]),
                decode_ms=dict(split=dec["split_ms_median"],
                               plain=dec["plain_ms_median"]),
                decode_cache_placements=dec["cache_placements"],
                decode_cache_seq=dict(kv=dec["cache_seq"],
                                      cross_kv=dec["cross_seq"]),
                bits_differ=diff + pre["bits_differ"] + dec["bits_differ"])


def vlm_split_bits(mesh, dev, layers=2, b=2, s=2048, decode_steps=2) -> dict:
    """pixtral-12b at its full width (d 5,120, 32 q / 8 kv heads, d_ff
    14,336, vocabulary 131,072, bf16 parameters, f32 moments) and
    ``layers`` layers on ``mesh``: one split train step (``b`` × ``s``
    tokens, patch embeddings over the first 1,024 positions), the split
    prefill and ``decode_steps`` split decode steps against the plain
    calls, bit for bit (``split_bits_at_width``)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    cfg = dataclasses.replace(get_config("pixtral-12b"), num_layers=layers)
    batch = SyntheticPipeline(DataConfig(cfg.vocab_size, s, b, seed=7)
                              ).batch(0, device=dev)
    batch["patch_embeds"] = torch.randn(
        (b, cfg.num_patch_tokens, cfg.d_model), dtype=torch.float32,
        device=dev, generator=torch.Generator(device=dev).manual_seed(1)
    ).to(torch.bfloat16)
    serve = {k: batch[k] for k in ("tokens", "patch_embeds")}
    return split_bits_at_width(cfg, mesh, dev, batch, serve, decode_steps)


def moe_split_bits(mesh, dev, layers=2, b=2, s=1024, decode_steps=2) -> dict:
    """qwen2-moe-a2.7b at its full width (d 2,048, 16 / 16 heads, 60
    routed experts padded to 64, top-4, 4 shared experts: a shared MLP
    of 5,632, vocabulary 151,936, bf16 parameters, f32 moments) and
    ``layers`` layers on ``mesh``: one split train step over ``b`` ×
    ``s`` tokens (one group of 2,048), the split prefill and
    ``decode_steps`` split decode steps against the plain calls, bit for
    bit (``split_bits_at_width``)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                              num_layers=layers)
    assert (b * s) % cfg.moe_group_size == 0, (b, s)
    batch = SyntheticPipeline(DataConfig(cfg.vocab_size, s, b, seed=9)
                              ).batch(0, device=dev)
    return split_bits_at_width(cfg, mesh, dev, batch,
                               {"tokens": batch["tokens"]}, decode_steps)


def ssm_split_bits(mesh, dev, layers=4, b=4, s=1024, decode_steps=2) -> dict:
    """mamba2-370m at its full width (d 1,024, d_inner 2,048, 32 heads
    of 64, state 128, chunk 256, vocabulary 50,280, f32 parameters and
    moments) and ``layers`` layers on ``mesh``: one split train step
    over ``b`` × ``s`` tokens, the split prefill and ``decode_steps``
    split decode steps (the states on their heads, the conv tails on
    their channels) against the plain calls, bit for bit
    (``split_bits_at_width``)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    cfg = dataclasses.replace(get_config("mamba2-370m"), num_layers=layers)
    batch = SyntheticPipeline(DataConfig(cfg.vocab_size, s, b, seed=11)
                              ).batch(0, device=dev)
    return split_bits_at_width(cfg, mesh, dev, batch,
                               {"tokens": batch["tokens"]}, decode_steps)


def hybrid_split_bits(mesh, dev, layers=13, b=2, s=1024,
                      decode_steps=2) -> dict:
    """zamba2-7b at its full width (d 3,584; the shared block's 32 q / 32
    kv heads of 112 and d_ff 14,336 on ``concat(x, x0)`` through
    ``w_in``; Mamba2 layers of 112 heads of 64, state 64, chunk 256;
    vocabulary 32,000; bf16 parameters, f32 moments) and ``layers``
    layers (13: 2 groups of 6, so that the shared block's gradient sums
    two applications, and a tail of 1) on ``mesh``: one split train step
    over ``b`` × ``s`` tokens, the split prefill and ``decode_steps``
    split decode steps (the ``shared_kv`` caches on their sequence, the
    states on their heads, the conv tails on their channels) against the
    plain calls, bit for bit (``split_bits_at_width``)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.models.transformer import hybrid_layout
    cfg = dataclasses.replace(get_config("zamba2-7b"), num_layers=layers)
    assert hybrid_layout(cfg) == (2, 6, 1), hybrid_layout(cfg)
    batch = SyntheticPipeline(DataConfig(cfg.vocab_size, s, b, seed=13)
                              ).batch(0, device=dev)
    return split_bits_at_width(cfg, mesh, dev, batch,
                               {"tokens": batch["tokens"]}, decode_steps)


def encdec_split_bits(mesh, dev, layers=2, b=2, s=1024, src=1024,
                      decode_steps=2) -> dict:
    """seamless-m4t-large-v2 at its full width (d 1,024, 16 q / 16 kv
    heads of 64, d_ff 8,192, vocabulary 256,206 padded to 256,256; bf16
    parameters, f32 moments) and ``layers`` encoder and ``layers``
    decoder layers on ``mesh``: one split train step over ``b`` × ``s``
    tokens and ``b`` × ``src`` source frames, the split prefill and
    ``decode_steps`` split decode steps (``kv`` on its sequence,
    ``cross_kv`` on the source's) against the plain calls, bit for bit
    (``split_bits_at_width``)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    cfg = dataclasses.replace(get_config("seamless-m4t-large-v2"),
                              encoder_layers=layers, decoder_layers=layers)
    batch = SyntheticPipeline(DataConfig(cfg.vocab_size, s, b, seed=15)
                              ).batch(0, device=dev)
    batch["src_embeds"] = torch.randn(
        (b, src, cfg.d_model), dtype=torch.float32, device=dev,
        generator=torch.Generator(device=dev).manual_seed(2)
    ).to(torch.bfloat16)
    serve = {k: batch[k] for k in ("tokens", "src_embeds")}
    return split_bits_at_width(cfg, mesh, dev, batch, serve, decode_steps)


def run_mesh(dev, smi, ckpt_dir, ckpt_step=50, name="smollm-135m", b=8,
             s=256, steps=5):
    """Phase 14: the distributed training and serving paths on a one-rank
    mesh (see the module docstring).  Restores phase 13's checkpoint of ``name`` at
    ``ckpt_step`` and removes it when done."""
    import shutil
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch._tree import tree_flatten_with_path, tree_leaves, tree_map
    from repro_torch.checkpoint import CheckpointManager, restore
    from repro_torch.configs import get_config
    from repro_torch.core import make_links, ring
    from repro_torch.core.latency import logical_latency
    from repro_torch.core.schedule import LogicalSynchronyNetwork
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.ft import plan_mesh, remesh
    from repro_torch.launch import (make_mesh_from_devices, make_train_step,
                                    state_shardings, value_and_grad)
    from repro_torch.models import ModelZoo
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.compression import (compress, compressed_psum,
                                               ef_roundtrip)
    from repro_torch.sched import pipeline_apply, plan
    t_phase = time.perf_counter()
    cfg = get_config(name)
    zoo = ModelZoo(cfg)
    opt = AdamWConfig(lr=3e-3, weight_decay=0.01)
    data = SyntheticPipeline(DataConfig(cfg.vocab_size, s, b, seed=0))
    meta = {"params": tree_map(
        lambda d: torch.empty(d.shape, dtype=torch.float32, device="meta"),
        zoo.param_defs())}
    meta["opt"] = adamw_init(meta["params"], opt)

    # 1. a one-rank group and its (1, 1) ("data", "model") mesh
    backend = "nccl" if dev.type == "cuda" else "gloo"
    card = {}
    if dev.type == "cuda":
        card["device_id"] = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(card["device_id"])
    t0 = time.perf_counter()
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, **card)
    try:
        mesh = remesh([0], model_size=1, device_type=dev.type)
        init_s = time.perf_counter() - t0
        assert tuple(mesh.shape) == (1, 1), mesh

        # 2. phase 13's checkpoint onto the mesh, against a plain restore
        t0 = time.perf_counter()
        state = restore(str(ckpt_dir), ckpt_step, meta,
                        shardings=state_shardings(cfg, mesh))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        plain = restore(str(ckpt_dir), ckpt_step, meta, device=dev)
        diff = mesh_state_bits(state, plain)
        row = dict(phase="mesh", part=name, nvidia_smi=smi, batch=b, seq=s,
                   backend=backend, mesh=list(mesh.shape),
                   axes=list(mesh.mesh_dim_names), init_s=init_s,
                   restore_s=restore_s, restored_from_step=ckpt_step,
                   leaves=len(tree_leaves(plain)), restore_bits_differ=diff)
        assert not diff, row

        # 3. the mesh step against the plain step, bit for bit
        step_fn = make_train_step(cfg, opt)
        p_m, o_m = state["params"], state["opt"]
        p, o = plain["params"], plain["opt"]
        mesh_ms, plain_ms, mesh_peak, plain_peak, reduces = [], [], [], [], []
        model_reduces = []
        losses = []

        def timed_step(*args):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.reset_peak_memory_stats()
            ev[0].record()
            out = step_fn(*args)
            ev[1].record()
            torch.cuda.synchronize()
            return out, ev[0].elapsed_time(ev[1]), \
                torch.cuda.max_memory_allocated()

        for i in range(steps):
            n = ckpt_step + i
            batch = data.batch(n, device=dev)
            (p_m, o_m, mm), ms_m, peak_m = timed_step(p_m, o_m, batch, n)
            (p, o, m), ms_p, peak_p = timed_step(p, o, batch, n)
            mesh_ms.append(ms_m)
            plain_ms.append(ms_p)
            mesh_peak.append(peak_m)
            plain_peak.append(peak_p)
            reduces.append(mm["all_reduces"])
            model_reduces.append(mm["model_all_reduces"])
            losses.append(float(m["loss"]))
            diff = mesh_state_bits({"params": p_m, "opt": o_m},
                                   {"params": p, "opt": o})
            if not bit_equal(mm["loss"], m["loss"]):
                diff.append("loss")
            if diff:
                row["step_bits_differ"] = dict(step=n, leaves=diff)
                emit(row)
                raise AssertionError(row)
        row.update(steps=steps, step_numbers=[ckpt_step, ckpt_step + steps - 1],
                   losses=losses, mesh_step_ms=mesh_ms, plain_step_ms=plain_ms,
                   mesh_step_ms_median=float(np.median(mesh_ms)),
                   plain_step_ms_median=float(np.median(plain_ms)),
                   mesh_peak_memory_bytes=max(mesh_peak),
                   plain_peak_memory_bytes=max(plain_peak),
                   all_reduces_per_step=reduces,
                   model_all_reduces_per_step=model_reduces,
                   split_layout=split_layout(cfg, mesh, p_m),
                   steps_bit_identical=steps)

        # 3b. the split prefill on the same state, bit for bit
        row["prefill"] = split_prefill_bits(cfg, p_m, p,
                                            {"tokens": batch["tokens"]}, dev)
        row["reduced_llama3_8b"] = reduced_split_bits(mesh, dev)
        # 3c. the split decode after the split prefill, and the VLM family
        row["decode"] = split_decode_bits(cfg, p_m, p,
                                          {"tokens": batch["tokens"]}, dev)
        row["pixtral_12b"] = vlm_split_bits(mesh, dev)
        # 3d. the MoE family: experts, shared MLP and routing on the split
        row["qwen2_moe_a2_7b"] = moe_split_bits(mesh, dev)
        # 3e. the SSM family: heads, the gated norm's sum, the state cache
        row["mamba2_370m"] = ssm_split_bits(mesh, dev)
        # 3f. the hybrid family: the shared block and the Mamba2 groups
        row["zamba2_7b"] = hybrid_split_bits(mesh, dev)
        # 3g. the encoder-decoder family: the cross-attention, cross_kv
        row["seamless_m4t_large_v2"] = encdec_split_bits(mesh, dev)
        emit(dict(phase="mesh", part="split", nvidia_smi=smi,
                  split_layout=row["split_layout"],
                  train_step_ms_median=row["mesh_step_ms_median"],
                  plain_step_ms_median=row["plain_step_ms_median"],
                  prefill=row["prefill"], decode=row["decode"],
                  reduced_llama3_8b=row["reduced_llama3_8b"],
                  pixtral_12b=row["pixtral_12b"],
                  qwen2_moe_a2_7b=row["qwen2_moe_a2_7b"],
                  mamba2_370m=row["mamba2_370m"],
                  zamba2_7b=row["zamba2_7b"],
                  seamless_m4t_large_v2=row["seamless_m4t_large_v2"]))
        for part in (row["prefill"], row["reduced_llama3_8b"],
                     row["decode"], row["pixtral_12b"],
                     row["qwen2_moe_a2_7b"], row["mamba2_370m"],
                     row["zamba2_7b"], row["seamless_m4t_large_v2"]):
            assert not part["bits_differ"], part

        # 4. save from the mesh, re-mesh the survivors, resume
        resume_dir = Path(str(ckpt_dir) + "_mesh")
        shutil.rmtree(resume_dir, ignore_errors=True)
        mgr = CheckpointManager(str(resume_dir), keep=1)
        n = ckpt_step + steps
        (_, save_s) = timed(lambda: mgr.save(n, {"params": p_m, "opt": o_m}))
        survivors = [0]
        assert plan_mesh(len(survivors), 1) == (1, 1)
        mesh2 = remesh(survivors, model_size=1, device_type=dev.type)
        got_n, resumed = mgr.restore_latest(
            meta, shardings=state_shardings(cfg, mesh2))
        assert got_n == n, got_n
        batch = data.batch(n, device=dev)
        _, _, m_resumed = step_fn(resumed["params"], resumed["opt"], batch, n)
        _, _, m_on = step_fn(p_m, o_m, batch, n)
        row["resume"] = dict(
            step=n, save_s=save_s, survivors=survivors,
            mesh=list(mesh2.shape),
            restore_bits_differ=mesh_state_bits(
                resumed, tree_map(lambda t: t.full_tensor(),
                                  {"params": p_m, "opt": o_m})),
            resumed_loss=float(m_resumed["loss"]),
            uninterrupted_loss=float(m_on["loss"]),
            loss_bit_identical=bit_equal(m_resumed["loss"], m_on["loss"]))
        shutil.rmtree(resume_dir, ignore_errors=True)
        del resumed, state, plain, o_m, o, p

        # 5. compression over every gradient leaf, the card against the CPU
        _, grads = value_and_grad(zoo.train_loss)(
            tree_map(lambda t: t.full_tensor(), p_m), batch)
        del p_m
        cpu = dist.new_group(backend="gloo")
        flat = tree_flatten_with_path(grads)
        comp = dict(leaves=len(flat), elements=sum(g.numel() for _, g in flat),
                    payload_bits_differ=[], residual_bits_differ=[],
                    psum_bits_differ=[])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        card_ef = [ef_roundtrip(g, torch.zeros_like(g)) for _, g in flat]
        ev[1].record()
        card_ps = [compressed_psum(g, torch.zeros_like(g), (mesh, "data"))
                   for _, g in flat]
        ev[2].record()
        torch.cuda.synchronize()
        comp["ef_roundtrip_ms"] = ev[0].elapsed_time(ev[1])
        comp["compressed_psum_ms"] = ev[1].elapsed_time(ev[2])
        for (path, g), (deq, res), (mean, res2) in zip(flat, card_ef,
                                                        card_ps):
            key = "/".join(path)
            g_cpu = g.cpu()
            deq_c, res_c = ef_roundtrip(g_cpu, torch.zeros_like(g_cpu))
            mean_c, res2_c = compressed_psum(g_cpu, torch.zeros_like(g_cpu),
                                             cpu)
            if not (bit_equal(deq.cpu(), deq_c)):
                comp["payload_bits_differ"].append(key)
            if not (bit_equal(res.cpu(), res_c) and bit_equal(res2.cpu(),
                                                               res2_c)):
                comp["residual_bits_differ"].append(key)
            if not bit_equal(mean.cpu(), mean_c):
                comp["psum_bits_differ"].append(key)
        # a max whose quotient by 127 and product with fl(1/127) part,
        # elements at halves of both int8 grids
        x, quot, _, parted = int8_scale_ties()
        g_c = torch.from_numpy(x)
        z_c = torch.zeros_like(g_c)
        g, z = g_c.to(dev), z_c.to(dev)
        pairs = {"ef_roundtrip": (ef_roundtrip(g, z), ef_roundtrip(g_c, z_c)),
                 "compressed_psum": (compressed_psum(g, z, (mesh, "data")),
                                     compressed_psum(g_c, z_c, cpu))}
        comp["scale_ties"] = dict(
            elements=len(x), int8_parted_by_the_product=parted,
            scale_is_quotient=float(compress(g)[1]) == float(quot),
            bits_differ=[f"{k}/{i}" for k, (card, host) in pairs.items()
                         for i, (a, b) in enumerate(zip(card, host))
                         if not bit_equal(a.cpu(), b)])
        row["compression"] = comp
        del grads, card_ef, card_ps

        # 6. the bittide-scheduled pipeline, one stage, smollm's width
        d = cfg.d_model
        rng = np.random.default_rng(0)
        ws = torch.tensor(rng.normal(0, d ** -0.5, (1, d, d)),
                          dtype=torch.float32, device=dev)
        x = torch.tensor(rng.normal(0, 1, (8, b, d)), dtype=torch.float32,
                         device=dev)
        stage_mesh = make_mesh_from_devices([0], (1,), ("stage",),
                                            device_type=dev.type)
        stage_fn = lambda w, h: torch.tanh(h @ w)
        (out, pipe_s) = timed(lambda: pipeline_apply(stage_fn, ws, x,
                                                     stage_mesh, "stage", 8))
        chain = torch.stack([stage_fn(ws[0], x[i]) for i in range(8)])
        topo = ring(4)
        lsn = LogicalSynchronyNetwork(topo, logical_latency(topo,
                                                            make_links(topo)))
        pl = plan(lsn, list(range(4)), 6, fwd_ticks=100, bwd_ticks=0,
                  activation_frames=8)
        row["pipeline"] = dict(
            stages=1, microbatches=8, shape=list(x.shape), wall_s=pipe_s,
            bit_identical_to_chain=bit_equal(out, chain),
            ring4_plan=dict(makespan_ticks=pl.makespan_ticks,
                            bubble_fraction=pl.bubble_fraction,
                            bounded=pl.bounded))
    finally:
        dist.destroy_process_group()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    # 3c-3g's full-width states are gone, but the allocator keeps their
    # freed blocks cached: hand them back, so that phase 15's trace
    # workers, each with a CUDA context of its own, find room beside its
    # real step
    row["reserved_bytes_at_end"] = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    row["reserved_bytes_after_release"] = torch.cuda.memory_reserved()
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    assert not row["resume"]["restore_bits_differ"], row["resume"]
    assert row["resume"]["loss_bit_identical"], row["resume"]
    for k in ("payload_bits_differ", "residual_bits_differ",
              "psum_bits_differ"):
        assert not comp[k], comp
    assert comp["scale_ties"]["scale_is_quotient"], comp["scale_ties"]
    assert not comp["scale_ties"]["bits_differ"], comp["scale_ties"]
    assert row["pipeline"]["bit_identical_to_chain"], row["pipeline"]
    assert row["pipeline"]["ring4_plan"]["bounded"], row["pipeline"]
    return row


def launch_step_analysis(dev, smi, serve_row, train_row, b=8, s=256):
    """Phase 15 (a): one real smollm-135m train step at phase 13's shape
    on the card under the FLOP and bytes counters, against the
    fake-tensor trace of the same step (``MemTracker``'s predicted peak
    too); the roofline terms against phase 13's measured step, the
    predicted peak against phase 13's, memmodel's decode bytes against
    phase 12's decode step.  No step is timed here."""
    import dataclasses
    import math
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.launch import (abstract_train_args, make_train_step,
                                    dryrun)
    from repro_torch.launch.hloanalysis import StepCounter
    from repro_torch.launch.memmodel import analytic_hbm_bytes
    from repro_torch.models import ModelZoo, materialize
    from repro_torch.optim import AdamWConfig, adamw_init
    t_start = time.perf_counter()
    name = "smollm-135m"
    cfg = get_config(name)
    zoo = ModelZoo(cfg)
    opt = AdamWConfig(lr=3e-3, weight_decay=0.01)
    step_fn = make_train_step(cfg, opt)
    shape = ShapeSpec("train", "train", s, b)

    # the real step, phase 13's state at step 0 and its first batch
    params = materialize(zoo.param_defs(),
                         torch.Generator(device=dev).manual_seed(0),
                         torch.float32, device=dev)
    opt_state = adamw_init(params, opt)
    batch = SyntheticPipeline(DataConfig(cfg.vocab_size, s, b, seed=0)).batch(
        0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    with StepCounter() as real:
        step_fn(params, opt_state, batch, 0)
    torch.cuda.synchronize()
    real_s = time.perf_counter() - t0
    del params, opt_state, batch

    # the same step traced on fake tensors of the card
    t0 = time.perf_counter()
    with FakeTensorMode():
        args = abstract_train_args(cfg, shape, None, ("data",), device=dev)
        tracker = MemTracker()
        tracker.track_external(*[t for t in tree_leaves(args)
                                 if isinstance(t, torch.Tensor)])
        with tracker, StepCounter() as fake:
            step_fn(*args)
    fake_s = time.perf_counter() - t0
    predicted_peak = sum(v["Total"] for v in
                         tracker.get_tracker_snapshot("peak").values())
    rc, fc = real.cost_analysis(), fake.cost_analysis()

    # the roofline terms of the real step on one card
    one_card = dataclasses.replace(cfg, sharding_profile="dp")
    fused = analytic_hbm_bytes(one_card, shape, chips=1)
    terms = {"compute_s": rc["flops"] / dryrun.PEAK_FLOPS,
             "memory_s": rc["bytes accessed"] / dryrun.HBM_BW,
             "memory_fused_s": fused / dryrun.HBM_BW,
             "collective_s": 0.0}
    bound_s = max(terms["compute_s"], terms["memory_fused_s"])
    step_s = train_row["step_ms_median"] / 1e3
    prompt = serve_row["prompt"]
    decode_shape = ShapeSpec("decode", "decode", prompt, serve_row["batch"])
    # memmodel at chips=1 keeps the production mesh's model axis: its
    # cache term is the K/V cache over 16; one card streams all of it
    decode_bytes = analytic_hbm_bytes(one_card, decode_shape, chips=1)
    kv_size = {"bfloat16": 2, "float8_e4m3fn": 1}[cfg.kv_cache_dtype]
    cache_bytes = kv_size * sum(math.prod(d.shape) for d in
                                tree_leaves(zoo.cache_defs(decode_shape)))
    one_card_decode_bytes = decode_bytes + cache_bytes * (1 - 1 / 16)
    measured_peak = train_row["peak_memory_bytes"]
    row = dict(
        phase="launch", part="step", arch=name, nvidia_smi=smi, batch=b,
        seq=s, real_flops=rc["flops"], fake_flops=fc["flops"],
        flops_equal=rc["flops"] == fc["flops"],
        real_bytes_accessed=rc["bytes accessed"],
        fake_bytes_accessed=fc["bytes accessed"],
        real_collectives=real.collective_stats()["total"]["count"],
        model_flops=zoo.model_flops(shape),
        counted_over_model_flops=rc["flops"] / zoo.model_flops(shape),
        init_s=init_s, real_step_s=real_s, fake_trace_s=fake_s,
        seconds=time.perf_counter() - t_start,
        terms=terms, terms_note=(
            "compute: the counted FLOPs over 989 TFLOP/s (dense bf16, H100 "
            "SXM data sheet); memory: the counted per-op bytes, and "
            "memmodel's fused estimate at chips=1 under the dp profile "
            "(the tp profile leaves no data-parallel chip on one card), "
            "over 3.35 TB/s; no collective on one card"),
        measured_step_ms=train_row["step_ms_median"],
        compute_fraction=terms["compute_s"] / step_s,
        roofline_fraction=bound_s / step_s,
        predicted_peak_bytes=predicted_peak,
        measured_peak_bytes=measured_peak,
        peak_ratio=predicted_peak / measured_peak,
        decode_shape=[serve_row["batch"], prompt],
        mesh_memmodel_decode_bytes=decode_bytes,
        mesh_memmodel_decode_ms=decode_bytes / dryrun.HBM_BW * 1e3,
        one_card_cache_bytes=cache_bytes,
        one_card_decode_bytes=one_card_decode_bytes,
        one_card_decode_ms=one_card_decode_bytes / dryrun.HBM_BW * 1e3,
        measured_decode_ms_per_step=serve_row["decode_ms_per_step"],
        mesh_memmodel_decode_share=decode_bytes / dryrun.HBM_BW * 1e3
        / serve_row["decode_ms_per_step"],
        one_card_decode_share=one_card_decode_bytes / dryrun.HBM_BW * 1e3
        / serve_row["decode_ms_per_step"])
    emit(row)
    assert row["flops_equal"], row
    assert rc["flops"] > 0 and row["real_collectives"] == 0, row
    assert real.unmatched == fake.unmatched == [], row
    return row


# The dry run's cells of phase 15 (b).  The first runs in a helper thread
# beside (a), the rest after (a); ``run_cell`` traces a cell's passes at
# once in worker processes, forked from the server ``main`` started.
LAUNCH_CELLS = (("smollm-135m", "train_4k"), ("mamba2-370m", "long_500k"),
                ("internlm2-1.8b", "decode_32k"),
                ("qwen2-moe-a2.7b", "decode_32k"),
                ("zamba2-7b", "decode_32k"),
                ("seamless-m4t-large-v2", "decode_32k"))

# Cells as the step counted them when every rank gathered every leaf over
# "model" (PERF.md §6): FLOPs per device (the roofline's composition) and
# bytes per device (arguments + temporaries, single pod).  smollm-135m ×
# train_4k's train step; internlm2-1.8b × decode_32k's decode, which also
# gathered the K/V caches' sequence over "model" (the dry run of the
# commit 7e926fc on the CPU); qwen2-moe-a2.7b × decode_32k's decode, which
# gathered its experts too (the dry run of the commit 838c564 on the CPU);
# mamba2-370m × long_500k's decode, which gathered its Mamba2 blocks (the
# dry run of the commit 22a1a09 with fake CUDA tensors on an H100 host);
# zamba2-7b × decode_32k's decode, which gathered its shared block, its
# Mamba2 layers and its shared_kv caches (the dry run of the commit
# 7691d16 with fake CUDA tensors on an H100 host);
# seamless-m4t-large-v2 × decode_32k's decode, which gathered its
# encoder-decoder blocks and its kv and cross_kv caches (the dry run of
# the commit ce3747b with fake CUDA tensors on an H100 host).
GATHERED_STEP = {
    ("seamless-m4t-large-v2", "decode_32k"): {
        "flops_per_device": 6.7817701376e10,
        "bytes_per_device": 110.416910848e9},
    ("zamba2-7b", "decode_32k"): {"flops_per_device": 2.0410335232e11,
                                  "bytes_per_device": 166.336930816e9},
    ("mamba2-370m", "long_500k"): {"flops_per_device": 7.60741888e8,
                                   "bytes_per_device": 2.246065664e9},
    ("smollm-135m", "train_4k"): {"flops_per_device": 1.412e14,
                                  "bytes_per_device": 23.25e9},
    ("internlm2-1.8b", "decode_32k"): {"flops_per_device": 7.8735474688e10,
                                       "bytes_per_device": 86.951010344e9},
    ("qwen2-moe-a2.7b", "decode_32k"): {"flops_per_device": 1.02978551808e11,
                                        "bytes_per_device": 188.288479272e9}}


def run_launch(dev, smi, serve_row, train_row):
    """Phase 15: the launch analysis (see the module docstring)."""
    import shutil
    import threading
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "dryrun_torch"
    shutil.rmtree(out_dir, ignore_errors=True)
    done = {}

    def cell(arch, shape):
        done[arch] = (dryrun.run_cell(arch, shape, str(out_dir)),
                      time.perf_counter() - t_phase)

    dryrun.open_fake_world(512)
    try:
        first = threading.Thread(target=cell, args=LAUNCH_CELLS[0])
        first.start()
        step = launch_step_analysis(dev, smi, serve_row, train_row)
        for args in LAUNCH_CELLS[1:]:
            cell(*args)
        first.join(timeout=600)
        assert not first.is_alive(), "the dry run's first cell hangs"
    finally:
        dist.destroy_process_group()
    shutil.rmtree(out_dir, ignore_errors=True)
    cells = []
    for arch, shape in LAUNCH_CELLS:
        r, done_s = done[arch]
        sp = r.get("single_pod", {})
        mem = sp.get("memory", {})
        roof = r.get("roofline", {})
        cells.append(dict(
            arch=arch, shape=shape, done_after_s=done_s,
            ok=r.get("ok"), error=r.get("error"),
            device_type=r.get("device_type"),
            trace_s={k: r[k]["compile_s"] for k in ("single_pod",
                                                    "multi_pod") if k in r},
            terms=roof.get("terms"), dominant=roof.get("dominant"),
            flops_per_device=roof.get("flops_per_device"),
            bytes_per_device=mem.get("argument_size_in_bytes", 0)
            + mem.get("temp_size_in_bytes", 0),
            exceeds_device_memory=sp.get("exceeds_device_memory"),
            collectives=sp.get("collectives", {}).get("total", {}).get(
                "count"),
            multi_pod_collectives=r.get("multi_pod", {}).get(
                "collectives", {}).get("total", {}).get("count"),
            unmatched=sp.get("unmatched_collectives"),
            tensor_parallel=r.get("tensor_parallel")))
        c = cells[-1]
        gathered = GATHERED_STEP.get((arch, shape))
        if gathered is not None and c["flops_per_device"] is not None:
            c["gathered_step"] = gathered
            c["flops_over_gathered"] = (c["flops_per_device"]
                                        / gathered["flops_per_device"])
            c["bytes_over_gathered"] = (c["bytes_per_device"]
                                        / gathered["bytes_per_device"])
    row = dict(phase="launch", part="dryrun", nvidia_smi=smi, world=512,
               cells=cells, seconds=time.perf_counter() - t_phase)
    emit(row)
    for c in cells:
        assert c["ok"] and c["error"] is None, c
        assert c["device_type"] == dev.type and not c["unmatched"], c
        assert c["flops_per_device"] > 0 and c["collectives"] > 0, c
    # the split steps do less per device than the gathered ones did, and
    # the split decode holds its share of the caches
    for c in cells:
        if (c["arch"], c["shape"]) in GATHERED_STEP:
            assert c["flops_over_gathered"] < 1.0, c
            assert c["bytes_over_gathered"] < 1.0, c
    return dict(step=step, dryrun=row)


# Phase 16: the port's examples (examples/torch_*.py) on the card.  Each
# card form: (example, argv, the kernels it must launch on the card).  The
# chaos campaign runs 64 draws of its 1,024 (phase 9 runs two 1,024-draw
# campaigns); the training example 20 steps of its 300, then a resume to
# step 24 from its own checkpoint.
EXAMPLES_DIR = ROOT / "build" / "examples"
EXAMPLE_CARD_FORMS = (
    ("quickstart", [], ()),
    ("cable_swap", ["--no-plot", "--engine", "auto"], ("fused",)),
    ("cable_swap", ["--no-plot", "--engine", "fused"], ("fused",)),
    ("cable_swap", ["--no-plot", "--engine", "tiled"], ("tiled",)),
    ("cable_swap", ["--no-plot", "--engine", "per-step"], ("per-step",)),
    ("cable_swap", ["--no-plot", "--engine", "segment-sum"], ()),
    ("auto_reframe", ["--no-plot"], ("fused",)),
    ("ensemble_sweep", ["--draws", "32"], ("fused",)),
    ("scale_torus", [], ("sparse",)),
    ("chaos_campaign", ["--no-plot", "--draws", "64"], ()),
    ("serve_bittide", ["--no-plot"], ()),
    ("serve_decode", [], ()),
    ("train_bittide_cluster",
     ["--steps", "20", "--ckpt-dir", str(EXAMPLES_DIR / "card_ckpt")], ()),
    ("train_bittide_cluster",
     ["--steps", "24", "--resume", "--ckpt-dir",
      str(EXAMPLES_DIR / "card_ckpt")], ()),
)
# Each example's smallest form, run on the card and then on the CPU in one
# process (``examples_small_forms``); scale_torus's is its
# ``sync_torus(6)`` (None).
EXAMPLE_SMALL_FORMS = (
    ("quickstart", []),
    ("cable_swap", ["--smoke", "--no-plot"]),
    ("auto_reframe", ["--smoke", "--no-plot"]),
    ("ensemble_sweep", ["--draws", "4"]),
    ("scale_torus", None),
    ("chaos_campaign", ["--smoke", "--no-plot"]),
    ("serve_bittide", ["--smoke", "--no-plot"]),
    ("serve_decode", ["--smoke"]),
    ("train_bittide_cluster", ["--tiny", "--steps", "3"]),
)
COUNTED_LANES = ("fused", "tiled", "sparse", "per-step", "segment-sum")


def load_example(name):
    """``examples/torch_<name>.py`` as a module."""
    import importlib.util
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name, argv, dev):
    """``main(argv + ["--device", dev])`` of ``examples/torch_<name>.py``
    with its standard output captured: (its value, its printed lines, its
    host wall, synchronized with the card)."""
    import io
    import torch
    mod = load_example(name)
    buf = io.StringIO()
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            value = mod.main([*argv, "--device", str(dev)])
        if cuda:
            torch.cuda.synchronize()
    except BaseException:
        sys.stderr.write(buf.getvalue())
        raise
    return value, buf.getvalue().splitlines(), time.perf_counter() - t0


def reset_launch_counts():
    """Every wrapper's launch count, and the segment-sum runs, to 0."""
    from repro_torch.core.frame_model import RUN_COUNT
    from repro_torch.kernels.bittide_sparse import bittide_sparse
    from repro_torch.kernels.bittide_step import (bittide_fused,
                                                  bittide_perstep,
                                                  bittide_tiled)
    for kernel in (bittide_fused, bittide_tiled, bittide_sparse,
                   bittide_perstep):
        kernel.launches = 0
    RUN_COUNT["segment-sum"] = 0


def example_digest(name, v):
    """What the card run and the CPU run of an example's smallest form
    must agree on: ``exact`` (integers, verdicts, strings), ``nu`` (ν
    records, ppm), ``beta`` (β records and queue peaks), ``conv``
    (convergence times with the ν records and times they come from),
    ``loss`` (training losses) and ``tokens`` (greedy tokens)."""
    import numpy as np
    d = dict(exact={}, nu={}, beta={}, conv={}, loss={}, tokens=None)
    if name == "quickstart":
        d["exact"] = dict(rtt=v["rtt_table"], lam=v["lam"].tolist(),
                          latency_0_1=v["latency_0_1"],
                          converged=v["converged"])
        d["nu"]["sync"] = v["freq_ppm"]
        d["conv"]["sync"] = (v["convergence_time_s"], v["freq_ppm"],
                             v["times"])
    elif name in ("cable_swap", "auto_reframe"):
        keys = (("engine", "num_launches", "chunk_records", "rtt_before",
                 "rtt_after", "rtt_shift", "other_shift")
                if name == "cable_swap" else
                ("engine", "num_launches", "reframes", "max_shift",
                 "rtt_residual", "rtt_shift"))
        d["exact"] = {k: v[k] for k in keys}
        d["nu"]["run"], d["beta"]["run"] = v["freq_ppm"], v["beta"]
        if name == "auto_reframe":
            d["exact"]["total_shift"] = v["total_shift"].tolist()
            d["nu"]["plain"] = v["plain_freq_ppm"]
            d["beta"]["plain"] = v["plain_beta"]
    elif name == "ensemble_sweep":
        runs = {**{f"distribution {k}": r
                   for k, r in v["distribution"].items()},
                **{f"dt {k}": r for k, r in v["dt_sweep"].items()},
                "kp sweep": v["kp_sweep"]}
        for k, r in runs.items():
            d["nu"][k] = r["freq_ppm"]
            d["conv"][k] = (r["conv"], r["freq_ppm"], r["times"])
        d["exact"]["dense_engine"] = v["dense"]["engine"]
        d["nu"]["dense"] = v["dense"]["freq_ppm"]
    elif name == "scale_torus":
        d["nu"]["sync_torus(6)"] = v["freq_ppm"]
        d["conv"]["sync_torus(6)"] = (v["conv_s"], v["freq_ppm"], v["times"])
    elif name == "chaos_campaign":
        d["exact"] = {k: v[k] for k in (
            "engine", "num_launches", "counts", "shrunk_draw",
            "shrunk_expected", "shrunk_verdict")}
        d["exact"]["verdicts"] = [str(x) for x in v["verdicts"]]
        d["nu"]["campaign"], d["beta"]["campaign"] = v["freq_ppm"], v["beta"]
    elif name == "serve_bittide":
        d["exact"] = {k: v[k] for k in ("segments", "num_launches",
                                         "requests", "tokens", "claim")}
        for disc, r in v["results"].items():
            d["exact"][disc] = dict(
                completed=r.completed, num_ticks=r.num_ticks,
                queue_peak=r.queue_peak,
                generated=r.generated_tokens.tolist())
        d["nu"]["pace"], d["beta"]["pace"] = v["freq_ppm"], v["beta"]
        d["summaries"] = [r.summary() for r in v["results"].values()]
    elif name == "serve_decode":
        d["tokens"] = v
    elif name == "train_bittide_cluster":
        d["exact"] = {k: v[k] for k in (
            "converged", "ring_transfers", "ring_makespan_ticks", "params",
            "start", "steps")}
        d["nu"]["sync"] = v["sync_freq_ppm"]
        d["conv"]["sync"] = (v["convergence_time_s"], v["sync_freq_ppm"],
                             v["sync_times"])
        d["beta"]["straggler_queue_peak"] = np.float64(
            v["straggler_queue_peak"])
        d["beta"]["straggler_uncontrolled_peak"] = np.float64(
            v["straggler_uncontrolled_peak"])
        d["loss"] = v["losses"]
    return d


def small_form(name, argv, dev):
    """One example's smallest form on ``dev``: its digest, wall and
    printed lines (scale_torus: ``sync_torus(6)``)."""
    if argv is None:
        t0 = time.perf_counter()
        _, res, _ = load_example(name).sync_torus(6, device=str(dev))
        value = dict(freq_ppm=res.freq_ppm, times=res.times,
                     conv_s=res.convergence_time(1.0))
        lines, wall = [], time.perf_counter() - t0
    else:
        if name == "train_bittide_cluster":
            argv = [*argv, "--ckpt-dir",
                    str(EXAMPLES_DIR / f"{dev}_tiny_ckpt")]
        value, lines, wall = run_example(name, argv, dev)
    return dict(digest=example_digest(name, value), wall_s=wall,
                lines=lines)


def examples_small_forms(out_path, card):
    """Every example's smallest form on ``card`` and then on the CPU in
    this process, pickled to ``out_path`` as {example: (card run, CPU
    run)}: phase 16 runs this in a process of its own beside its card
    forms."""
    import pickle
    import torch
    torch.set_num_threads(4)
    out = {name: (small_form(name, argv, card), small_form(name, argv, "cpu"))
           for name, argv in EXAMPLE_SMALL_FORMS}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def parted_convergence(card, cpu, band=1.0):
    """Records where the card's and the CPU's ν spreads lie on either
    side of the ``band`` (ppm) whence a convergence time is read: each
    must lie within ``FREQ_ATOL_PPM`` of the band on both sides, or the
    runs part (AssertionError).  Returns those records as (draw, record)
    pairs (an empty list: the times agree)."""
    import numpy as np
    (t_a, f_a, times), (t_b, f_b, _) = card, cpu
    f_a, f_b = np.asarray(f_a), np.asarray(f_b)
    if f_a.ndim == 2:
        f_a, f_b = f_a[None], f_b[None]
    s_a = f_a.max(axis=-1) - f_a.min(axis=-1)
    s_b = f_b.max(axis=-1) - f_b.min(axis=-1)
    sides = (s_a <= band) != (s_b <= band)
    named = [(int(b), int(r)) for b, r in zip(*np.nonzero(sides))]
    for b, r in named:
        assert abs(s_a[b, r] - band) <= 2 * FREQ_ATOL_PPM and \
            abs(s_b[b, r] - band) <= 2 * FREQ_ATOL_PPM, \
            f"convergence parts at draw {b}, record {r} (t={times[r]})"
    if not named:
        assert np.array_equal(np.asarray(t_a), np.asarray(t_b)), (t_a, t_b)
    return named


def decode_margins(tokens, batch=2, prompt=8):
    """The CPU's top-1 / top-2 logit margins along its own greedy tokens
    for ``examples/torch_serve_decode.py --smoke`` (its weights, prompt
    and reduced smollm-135m): prefill, then each token fed back."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import ModelZoo, widen_caches
    mod = load_example("serve_decode")
    cfg = get_config("smollm-135m").reduced()
    zoo = ModelZoo(cfg)
    params = mod.init_params(zoo, "cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt)), dtype=torch.int32)
    out = []
    with torch.inference_mode():
        logits, caches = zoo.prefill(params, {"tokens": toks})
        for i in range(tokens.shape[1]):
            top2 = logits[:, -1].float().topk(2, dim=-1).values
            out.append((top2[:, 0] - top2[:, 1]).numpy())
            if i + 1 < tokens.shape[1]:
                logits, caches = zoo.decode(
                    params, widen_caches(caches),
                    {"tokens": torch.as_tensor(tokens[:, i:i + 1])})
    return np.stack(out, axis=1)


def compare_small_forms(name, card, cpu) -> dict:
    """Phase 16's card-against-CPU row for one example's smallest form:
    integers and verdicts equal, ν at ``FREQ_ATOL_PPM``, β and queue
    peaks at ``BETA_ATOL_CROSS_FRAMES``, convergence times equal but at
    records named by ``parted_convergence``, losses at
    ``TRAIN_LOSS_REL``, tokens under ``GREEDY_MARGIN``.  Asserts after
    the caller emits it (``row["ok"]``)."""
    import numpy as np
    a, b = card["digest"], cpu["digest"]
    row = dict(phase="examples", part="card_vs_cpu", example=name,
               card_wall_s=card["wall_s"], cpu_wall_s=cpu["wall_s"],
               exact_equal=a["exact"] == b["exact"], nu_err_ppm={},
               beta_err={}, conv_parted={}, loss_rel={})
    for k in a["nu"]:
        row["nu_err_ppm"][k] = float(np.abs(np.asarray(a["nu"][k])
                                            - np.asarray(b["nu"][k])).max())
    for k in a["beta"]:
        x, y = np.asarray(a["beta"][k]), np.asarray(b["beta"][k])
        row["beta_err"][k] = (float(np.abs(x - y).max()) if x.size else 0.0)
    for k in a["conv"]:
        row["conv_parted"][k] = parted_convergence(a["conv"][k],
                                                   b["conv"][k])
    for step, loss in b["loss"].items():
        row["loss_rel"][str(step)] = abs(a["loss"][step] - loss) / abs(loss)
    row["nu_bit_equal"] = all(np.array_equal(a["nu"][k], b["nu"][k])
                              for k in a["nu"])
    if "summaries" in a:
        row["summaries_equal"] = a["summaries"] == b["summaries"]
    if a["tokens"] is not None:
        margins = decode_margins(b["tokens"])
        sure = margins > GREEDY_MARGIN
        compared = []
        for i in range(b["tokens"].shape[0]):
            n = int(np.argmin(sure[i])) if not sure[i].all() \
                else sure.shape[1]
            compared.append(n)
            row.setdefault("tokens_equal", True)
            row["tokens_equal"] &= bool(np.array_equal(
                a["tokens"][i, :n], b["tokens"][i, :n]))
        row["tokens_compared"] = compared
        row["tokens_identical"] = bool(np.array_equal(a["tokens"],
                                                      b["tokens"]))
    row["ok"] = bool(
        row["exact_equal"]
        and all(e <= FREQ_ATOL_PPM for e in row["nu_err_ppm"].values())
        and all(e <= BETA_ATOL_CROSS_FRAMES
                for e in row["beta_err"].values())
        and all(e <= TRAIN_LOSS_REL for e in row["loss_rel"].values())
        and row.get("tokens_equal", True)
        and (row.get("summaries_equal", True) or not row["nu_bit_equal"]))
    return row


def run_examples(dev, smi):
    """Phase 16: every port example on the card (see the module
    docstring).  Returns per kernel the launches from the examples and the
    worst errors of the engine calls held against the plain versions."""
    import pickle
    import shutil
    import torch
    from repro_torch.kernels import ops
    from repro_torch.scenarios import runner
    from repro_torch.telemetry import launch_counts
    t_phase = time.perf_counter()
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    EXAMPLES_DIR.mkdir(parents=True)
    small_out = EXAMPLES_DIR / "small_forms.pkl"
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import chip_smoke; chip_smoke.examples_small_forms("
            f"{str(small_out)!r}, {str(dev)!r})")
    small_proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                  stdout=subprocess.DEVNULL)
    try:
        launches = {k: 0 for k in COUNTED_LANES}
        held = {}
        for name, argv, kernels in EXAMPLE_CARD_FORMS:
            with contextlib.ExitStack() as stack:
                calls = {k: stack.enter_context(recorded_engine_calls(m, e))
                         for k, (m, e) in {
                             "scenario dense": (runner, "_fused_engine"),
                             "scenario per-step": (runner, "_perstep_engine"),
                             "dense": (ops, "_fused_engine"),
                             "sparse": (ops, "_sparse_engine")}.items()}
                reset_launch_counts()
                value, lines, wall = run_example(name, argv, dev)
                counts = launch_counts()
            row = dict(phase="examples", part="card", example=name,
                       argv=argv, nvidia_smi=smi, wall_s=wall,
                       launches=counts, printed=lines)
            if name == "chaos_campaign":
                row["cut"] = ("64 draws of the example's 1,024 on "
                              "torus3d(8) x 4,800 periods: phase 9 runs "
                              "two 1,024-draw campaigns")
            if name == "train_bittide_cluster":
                row["losses"] = value["losses"]
            for k in COUNTED_LANES:
                launches[k] += counts[k]
            # one engine call per kernel and card form, held at 0.0 (a
            # guarded one where the form ran the guard)
            for a, out in [c for k in ("scenario dense", "dense")
                           for c in sorted(calls[k], key=lambda c:
                                           not c[0]["record_guard"])[:1]]:
                for kern, w in hold_engine_calls([(a, out)], 50,
                                                 exact=True).items():
                    row.setdefault("held", {})[kern] = w
            if calls["scenario per-step"]:
                row.setdefault("held", {})["bittide_step"] = \
                    hold_perstep_calls(calls["scenario per-step"][:1], 50)
            if calls["sparse"]:
                row.setdefault("held", {})["bittide_sparse"] = \
                    hold_sparse_calls(calls["sparse"][:1])
            del calls
            emit(row)
            for kern in kernels:
                assert counts[kern] > 0, (name, argv, kern, counts)
            for kern, w in row.get("held", {}).items():
                assert w["freq_ppm"] == 0.0 and w["beta_frames"] == 0.0, \
                    (name, kern, w)
                h = held.setdefault(kern, dict(calls=0, freq_ppm=0.0,
                                               beta_frames=0.0))
                h["calls"] += w["calls"]
                h["freq_ppm"] = max(h["freq_ppm"], w["freq_ppm"])
                h["beta_frames"] = max(h["beta_frames"], w["beta_frames"])
            if name == "train_bittide_cluster" and "--resume" in argv:
                assert value["start"] == 20 and sorted(value["losses"]) \
                    == [20, 21, 22, 23], value["losses"]
        for kern in ("fused", "tiled", "sparse", "per-step"):
            assert launches[kern] > 0, (kern, launches)
        t_card = time.perf_counter() - t_phase

        # the smallest forms, card and CPU, from their own process
        t0 = time.perf_counter()
        rc = small_proc.wait(timeout=600)
        small_wait = time.perf_counter() - t0
        assert rc == 0, f"the smallest forms' process exited {rc}"
        with open(small_out, "rb") as f:
            small = pickle.load(f)
    finally:
        if small_proc.poll() is None:
            small_proc.kill()
            small_proc.wait()
    rows = [compare_small_forms(name, *small[name])
            for name, _ in EXAMPLE_SMALL_FORMS]
    for r in rows:
        emit(r)
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    total = dict(phase="examples", part="total", nvidia_smi=smi,
                 launches=launches, card_forms_s=t_card,
                 small_forms_wait_s=small_wait,
                 seconds=time.perf_counter() - t_phase)
    emit(total)
    for r in rows:
        assert r["ok"], r
    torch.cuda.empty_cache()
    return dict(launches=launches, held=held, total=total)


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no port beside the script ({ROOT / 'src'} "
              "holds no repro_torch)", file=sys.stderr)
        return 3
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core import (ControllerConfig, SimConfig, cube,
                                  fully_connected, make_links, simulate,
                                  simulate_ensemble, torus3d)
    from repro_torch.core.frame_model import RUN_COUNT
    from repro_torch.kernels import build
    from repro_torch.telemetry import Telemetry
    from repro_torch.launch import dryrun
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    t_start = time.perf_counter()
    # phase 15's dry-run workers fork from a server whose imports run
    # beside the phases before it; it ends when this process exits
    dryrun.start_worker_server()

    # 1. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = build.build(["bittide_fused", "bittide_tiled", "bittide_sparse",
                        "bittide_step"])
    seconds = time.perf_counter() - t0
    for name, lib in libs.items():
        log = lib.with_suffix(".so.log")
        ptxas = ([ln.strip() for ln in log.read_text().splitlines()
                  if "registers" in ln or "spill" in ln or "smem" in ln]
                 if log.exists() else ["library already built; no ptxas log"])
        emit(dict(phase="build", kernel=name, library=lib.name,
                  seconds=seconds, ptxas=ptxas, nvidia_smi=smi,
                  torch=torch.__version__, cuda=torch.version.cuda))
    print(smi, flush=True)

    # 2. kernel vs plain version
    worst = phase_parity(dev)

    # 3. main path: FC8 ensemble at users' size
    fc8, *_ = run_main_path(
        "fc8", fully_connected(8), 4096, 2e-8, 5e-5, 10_000, 20,
        Telemetry(beta=True, watermarks=True), dev, "fused", subset=256,
        reps=3)
    emit(fc8)

    # 4. dense torus at the fused regime's size
    torus, *_ = run_main_path(
        "torus", torus3d(6), 256, 2e-8, 1e-3, 2_000, 20,
        Telemetry(watermarks=True), dev, "fused", subset=16, reps=2)
    emit(torus)

    # 5. segment-sum lane
    topo = cube()
    links = make_links(topo, cable_m=2.0)
    ppm = np.random.default_rng(0).uniform(-8, 8, (64, 8))
    ctrl = ControllerConfig(kind="discrete", kp=2e-8, fs=1e-7,
                            pulses_per_update=50)
    cfg = SimConfig(dt=1e-3, steps=2_000, record_every=20,
                    quantize_beta=True)
    torch.cuda.reset_peak_memory_stats()
    RUN_COUNT["segment-sum"] = 0
    t0 = time.perf_counter()
    ens = simulate_ensemble(topo, links, ctrl, ppm, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runs = RUN_COUNT["segment-sum"]
    one = simulate(topo, links, ControllerConfig(kind="discrete", kp=2e-8,
                                                 fs=1e-7,
                                                 pulses_per_update=50),
                   ppm[3], cfg)
    seg = dict(phase="segsum", topology=topo.name, draws=64, steps=2_000,
               record_every=20, dt=1e-3, controller="discrete",
               quantize_beta=True, runs=runs, wall_s=wall,
               node_steps_per_s_wall=64 * 8 * 2_000 / wall,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               single_draw_bit_identical=bool(
                   np.array_equal(one.freq_ppm, ens.freq_ppm[3])),
               **summary(ens.freq_ppm, ens.times))
    emit(seg)
    assert runs == 1 and np.isfinite(ens.freq_ppm).all()
    assert seg["single_draw_bit_identical"]
    assert seg["converged_draws"] == 64 and seg["final_band_ppm_max"] <= 1.0

    # 6. the tiled lane at Fig-18 size
    tiled, tiled_res = run_tiled(dev)
    emit(tiled)

    # 7. the scenario runner
    scen = run_scenarios(dev)

    # 8. the sparse lane at full width, and at phase 6's size
    sparse = run_sparse(dev)
    emit(sparse)
    emit(run_sparse_fig18(dev, tiled))

    # 9. chaos campaigns on the sparse lane
    chaos = run_chaos(dev)

    # 10. the per-step lane: Fig-18 scale, the cable swap through the
    # facade, the guard's host resync, the quickstart
    perstep = run_perstep(dev, tiled_res, scen)

    # 11. the serving simulator paced on the card, and straggler pacing
    serving = run_serve(dev)

    # 12. model serving: smollm-135m and mamba2-370m at full width, every
    # architecture (reduced) on the card against the CPU; no kernel
    models = run_models(dev, smi)

    # 13. the training path: the example's cluster flow and smollm-135m
    # for 60 steps with a checkpoint, mamba2-370m, every architecture
    # (reduced) on the card against the CPU; no kernel
    train = run_train(dev, smi)

    # 14. the distributed training path on a one-rank NCCL mesh: phase
    # 13's checkpoint restored onto the mesh, the mesh step against the
    # plain step, the re-mesh and resume, compression, the pipeline
    run_mesh(dev, smi, ROOT / "build" / "phase13_ckpt")

    # 15. the launch analysis: a real step's FLOPs against its fake trace,
    # with phases 12 and 13's measurements; the dry run of two cells on a
    # fake 512-rank world; no kernel
    run_launch(dev, smi, models["smollm"], train["smollm"])

    # 16. the port's examples on the card, each through its main(argv);
    # their smallest forms on the card against the CPU
    examples = run_examples(dev, smi)

    # The kernels line, the card line, the last line.  Launches: the main
    # paths' counts (phases 3, 4, 6, 7, 8, 9, 10 and 11; the fused, tiled and
    # sparse wrappers count their calls that launched — one bittide_tiled
    # or bittide_sparse call launches a kernel per period and two or three
    # per measure pass from C — and bittide_perstep counts the kernels its
    # C loop launched).  Errors: the worst over every comparison with the
    # plain version (phase 2, the main paths' launches, phases 7, 9, 10
    # and 11's engine calls).
    errs = {k: dict(w) for k, w in worst.items()}

    def fold(kernel, freq_ppm, beta_frames):
        e = errs[kernel]
        e["freq_ppm"] = max(e["freq_ppm"], freq_ppm)
        e["beta_frames"] = max(e["beta_frames"], beta_frames)
    for kernel, row in (("bittide_fused", fc8), ("bittide_fused", torus),
                        ("bittide_tiled", tiled)):
        fold(kernel, row["kernel_vs_plain_freq_err_ppm"],
             row.get("kernel_vs_plain_beta_err_frames", 0.0))
    for kernel, h in zip(scen["held_kernels"], scen["held"]):
        fold(kernel, h["freq_ppm"], h["beta_frames"])
    fold("bittide_sparse", sparse["kernel_vs_plain_freq_err_ppm"], 0.0)
    for h in chaos["held"]:
        fold("bittide_sparse", h["freq_ppm"], h["beta_frames"])
    for h in perstep["held"]:
        fold("bittide_step", h["freq_ppm"], h["beta_frames"])
    for h in serving["held"]:
        fold("bittide_fused", h["freq_ppm"], h["beta_frames"])
    for kernel, h in examples["held"].items():
        fold(kernel, h["freq_ppm"], h["beta_frames"])
    ps = perstep["a"]
    emit(dict(phase="total", seconds=time.perf_counter() - t_start))
    no_library = ("no single PyTorch call runs the period loop (a matmul "
                  "covers only one period's aggregation)")
    emit({"kernels": [
        dict(name="bittide_fused", route="cuda",
             source="src/repro_torch/kernels/csrc/bittide_fused.cu",
             replaces="src/repro/kernels/bittide_step.py:271 (_fused_kernel)",
             launches=fc8["launches"] + torus["launches"]
             + scen["fused_launches"] + serving["fused_launches"],
             examples_launches=examples["launches"]["fused"],
             max_abs_err=errs["bittide_fused"]["freq_ppm"],
             max_err_ppm=errs["bittide_fused"]["freq_ppm"],
             max_beta_err_frames=errs["bittide_fused"]["beta_frames"],
             ms=fc8["kernel_ms"], plain_ms=fc8["plain_ms"],
             bound_ms=fc8["bound_ms"], bound_by=fc8["bound_by"],
             latency_bound_ms=fc8["latency_bound_ms"],
             latency_bound_note=(
                 f"serial periods at {fc8['max_sm_clock_mhz']} MHz: "
                 "the longest row's dependent adds + one per class + "
                 f"{UPDATE_CHAIN_OPS} update operations at "
                 f"{FP32_DEP_CYCLES} cycles and one synchronisation "
                 f"round ({fc8['latency_bound_sync_cycles']} cycles at "
                 "phase 3, "
                 f"{torus['latency_bound_sync_cycles']} at phase 4), + N "
                 "adds per measure pass; cycle costs measured by "
                 "scripts/torch_latency_probe.py"),
             unit="phase 3's call (FC8, B=4096, 10,000 periods)",
             phase4_ms=torus["kernel_ms"], phase4_bound_ms=torus["bound_ms"],
             phase4_latency_bound_ms=torus["latency_bound_ms"],
             launch_plans=[fc8["launch_plan"], torus["launch_plan"]],
             phase11_launches=serving["fused_launches"],
             phase11_ms_per_call=serving["kernel_ms_per_call"],
             phase11_note="pace_workers(engine='fused'): ring(8), B=2; "
                          "CUDA-event ms per engine call (one call per "
                          "event segment's chunk), (a) the example, (b) "
                          "the serving_goodput lane",
             library_ms=None, library_note=no_library),
        dict(name="bittide_tiled", route="cuda",
             source="src/repro_torch/kernels/csrc/bittide_tiled.cu",
             replaces="src/repro/kernels/bittide_step.py:744 (_tiled_kernel)",
             launches=tiled["launches"] + scen["tiled_launches"],
             examples_launches=examples["launches"]["tiled"],
             max_abs_err=errs["bittide_tiled"]["freq_ppm"],
             max_err_ppm=errs["bittide_tiled"]["freq_ppm"],
             max_beta_err_frames=errs["bittide_tiled"]["beta_frames"],
             ms=tiled["kernel_ms_per_pass"],
             plain_ms=tiled["plain_ms_per_pass"],
             bound_ms=tiled["bound_ms_per_pass"],
             bound_by=tiled["bound_by_per_pass"],
             library_ms=tiled["library_ms_per_pass"],
             unit=f"one pass of phase 6's {tiled['topology']} x "
                  f"{tiled['draws']} draws run; the call's time over its "
                  "periods and measure passes (the plain version's over "
                  f"its {tiled['plain_passes']} passes)",
             ms_per_call=tiled["kernel_ms"],
             plain_ms_per_call=tiled["plain_ms"],
             plain_work=tiled["plain_work"],
             ms_same_work_as_plain=tiled["kernel_ms_same_work"],
             bound_ms_per_call=tiled["bound_ms"],
             bound_by_per_call=tiled["bound_by"],
             library_note="one fp32 torch.matmul (B, N) x (N, N) per pass: "
                          "the aggregation of one period only, not the "
                          "update; not used by the port"),
        dict(name="bittide_sparse", route="cuda",
             source="src/repro_torch/kernels/csrc/bittide_sparse.cu",
             replaces="src/repro/kernels/bittide_sparse.py:161 "
                      "(_sparse_kernel)",
             launches=sparse["launches"] + chaos["launches"],
             examples_launches=examples["launches"]["sparse"],
             max_abs_err=errs["bittide_sparse"]["freq_ppm"],
             max_err_ppm=errs["bittide_sparse"]["freq_ppm"],
             max_beta_err_frames=errs["bittide_sparse"]["beta_frames"],
             ms=sparse["kernel_ms"], plain_ms=sparse["plain_ms"],
             plain_work=sparse["plain_work"],
             bound_ms=sparse["bound_ms"], bound_by=sparse["bound_by"],
             library_ms=sparse["library_ms"],
             library_note=("two torch.sparse CSR products per pass (w·ψ and "
                           "(w·lat)·ν, (N, N) x (N, B)), timed over phase "
                           f"8's {sparse['passes']} passes; the aggregation "
                           "only, not the update; not used by the port")),
        dict(name="bittide_step", route="cuda",
             source="src/repro_torch/kernels/csrc/bittide_step.cu",
             replaces="src/repro/kernels/bittide_step.py:137 (_kernel)",
             launches=perstep["launches"],
             examples_launches=examples["launches"]["per-step"],
             max_abs_err=errs["bittide_step"]["freq_ppm"],
             max_err_ppm=errs["bittide_step"]["freq_ppm"],
             max_beta_err_frames=errs["bittide_step"]["beta_frames"],
             ms=ps["kernel_ms_per_pass"], plain_ms=ps["plain_ms_per_pass"],
             bound_ms=ps["bound_ms_per_pass"], bound_by=ps["bound_by"],
             library_ms=ps["library_ms_per_pass"],
             unit=f"one pass (one launch) of phase 10's {ps['topology']} "
                  "run; the call's time over its periods and measure "
                  "passes",
             ms_per_draw_call=ps["kernel_ms_per_draw"],
             plain_work=ps["plain_work"],
             library_note=ps["library_note"])]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
