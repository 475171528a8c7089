#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with an H100 (sm_90a),
``nvcc`` and PyTorch built for CUDA.  It imports nothing of JAX or of the
JAX package.  Every phase prints one JSON line (also written to
``chiprun_out/chip_smoke.jsonl``):

1. ``card``      the card's name and power limit (``nvidia-smi``), torch
                 and CUDA versions.
2. ``build``     nvcc builds the kernels from ``src/repro_torch/csrc``;
                 seconds, and ptxas' registers/shared memory per kernel.
   ``engine``    the LLM stack through ``repro_torch.compile(cfg,
                 target="engine")``, in a child process (``python3
                 chip_smoke.py --engine``) that has the card's memory to
                 itself: (a) the seven transformer-family SMOKE configs on
                 the card against the CPU, the same weights made on the
                 CPU from a seed (f32 forward within 1e-4 x max(1,
                 max|logits|), prefill plus 8 greedy steps giving the same
                 tokens, bf16 forward within the 0.05 budget); (b)
                 qwen2.5-14b whole (48 layers, made on the card): prefill
                 and decode against the forward at f32, then prefill
                 (4 x 512) and decode (batch 1 and 8; bf16 also at
                 decode_32k's depth, batch 4) ms, tokens/s, busy share,
                 bound and top device ops, over f32 masters ("exact") and
                 bf16 weights; (c) mixtral-8x22b at its widths, 2 layers,
                 decode against forward past its 4096-token ring.  Every
                 ``exe(...)`` call is a replay of the signature's captured
                 forward; the ``engine_forward`` row: qwen2.5-14b at bf16,
                 a 2 x 256 program then a 4 x 512 one (the pool laid out
                 again, its growth within the larger program's pool x
                 1.1), the 4 x 512 replay bit-equal to ``model.forward``
                 run eagerly, host and device ms beside the eager
                 forward's, launches, busy share, bound.  No kernel of
                 ``csrc/`` is on this path: the reference's LLM attention
                 is jnp, computed here with torch ops.
   ``serve``     the serve scheduler (``repro_torch.serve``), in a child
                 process (``python3 chip_smoke.py --serve``): (a) the ten
                 SMOKE configs at f32 served on the card and on the CPU
                 over the same weights, batch and length buckets, chunked
                 prefill and a prefix cache where the family has them,
                 requests arriving mid-run: tokens equal, logits within
                 1e-4 x max(1, max|logits|), every card decode step one
                 replay of a captured CUDA graph; (b) qwen2.5-14b whole
                 at bf16 with ``fold=True``, 8 slots, 32 requests (64-1024
                 prompt tokens, 8 sharing a head, 64 new tokens): tokens/s,
                 TTFT, captured against eager step ms, launches and busy
                 share of one replay, bucket and prefix counters, peak
                 memory; a replay bit-equal to eager ``decode_step`` on a
                 clone of the cache, no buffer moved and no byte
                 allocated over 6 steady steps, and the same requests at
                 a fixed shape giving the same tokens, every request;
                 a probe of each decode product's rows at M = 1, 2, 4, 8
                 against M = 8, bare and under ``step_rows`` (equal as
                 the step runs them), and of whole decode steps: each bucket's row 0 against the
                 full-slots step's, captured and eager, and where eager
                 rows first part; (c)
                 mamba2-780m whole at f32, 300-token prompts across a
                 padded SSD chunk: served logits within 1e-3 x max(1,
                 max|logits|) of the forward's, tokens its argmax; (e)
                 the ten SMOKE configs with neither chunks nor length
                 buckets: tokens equal to the CPU's, one captured
                 whole-prompt program a prompt length, a replay
                 bit-equal to ``model.prefill`` on a zeroed cache.
   ``shard``     sharded compilation (``repro_torch.dist``), in a child
                 process (``python3 chip_smoke.py --shard``): (a)
                 ``mesh="data=1,model=1"`` on the ``cuda`` target, the six
                 CNNs at exact and three at int8 (batch 1 and 256) and
                 the decode graph (batch 8), bit-equal to the unsharded
                 captured programs, every call a replay; (b) two rank
                 processes on the card over gloo (``--shard-rank``),
                 ``model=2`` and then ``data=2``: C-HTWK, C-BH and VGG19
                 at exact and int8, batch 1 and 256, against the
                 unsharded program of this process (f32 within 1e-5 x
                 max(1, max|out|), int8 bit-equal; under ``data=2`` each
                 rank's rows bit-equal to the unsharded program on those
                 rows), each rank's B1/B2 launches from the profiler
                 (> 0) and host ms per call; (d) a ``"sharded"``
                 artifact in a fresh process (placement replayed, cache
                 hit, bit-equal); (e) ``MeshUnavailableError`` for
                 ``data=2,model=2`` in one process.
   ``mesh``      mesh serving and the models' sharded forms, in a child
                 process (``python3 chip_smoke.py --mesh``), whose own
                 child (``--mesh-single``) first runs each case on one
                 device: (m1) qwen2.5-14b whole at bf16, ``fold=False``,
                 on ``data=2`` (two rank processes on the card over gloo,
                 ``--mesh-rank``), 8 slots, max_len 1024, buckets and
                 256-token chunks, a 4-entry prefix cache, 16 requests of
                 64-768 prompt tokens and 32 new: tokens equal to the
                 single-device run's, every decode step with rows on a
                 rank a replay; tokens/s, TTFT, replay ms, the token
                 exchange's bytes and ms a step, peak GB a rank; (m2) the
                 same weights on ``model=2``, 4 requests of 64-256 tokens,
                 16 new: tokens equal, ``captured: false``, the gathered
                 bytes and ms and the step's ms, its whole-prompt
                 programs captured, peak GB within the rank's share; (m3) whisper-base whole at
                 f32 on ``data=2,model=2`` (four ranks), 8 requests with
                 their own 1500 frames, 32 new: tokens equal; (m4)
                 mixtral-8x22b at its widths (2 layers, f32), its
                 expert-parallel forward on ``model=2`` (4 of 8 experts a
                 rank) within 1e-5 x max(1, max|logits|) of the unsharded
                 forward, peak GB a rank; (m5) the partitioned serving
                 program (``launch.cells.serve_program``, the reference's
                 prefill and decode cells) of qwen2.5-14b at its widths
                 (4 of 48 layers, f32) on ``model=2``: a prefill of 4 x
                 256 tokens, then 8 greedy decode steps, each rank
                 holding its placed part of the params and of the cache
                 (flash-decoding over its half of the positions); every
                 step's gathered logits within 1e-5 x max(1,
                 max|logits|) of one device's and the tokens equal; step
                 ms, the ``model`` collectives' count, bytes and ms a
                 step, the held bytes against the placed, peak GB a
                 rank.
   ``train``     the trainer (``repro_torch.training``, ``.checkpoint``,
                 ``.data``, ``.launch.train``), in a child process
                 (``python3 chip_smoke.py --train``): (t1) the ten SMOKE
                 configs' loss, gradients and one captured train step on
                 the card against the CPU from the same params and batch
                 (f32: loss
                 within 1e-5 x max(1, |loss|), every gradient leaf within
                 1e-4 x max(1, max|g|), grad_norm within 1e-5 relative;
                 bf16 loss within 0.05 x max(1, |loss|)); (t4, a child
                 ``--train-bits`` under deterministic algorithms) 3
                 captured steps bit-equal to 3 eager ones, each SMOKE
                 config and minicpm-2b at its widths cut to 4 layers;
                 (t3a, beside
                 (t3b)) the launcher at SMOKE size in processes under
                 deterministic algorithms, 6 steps then resumed to 10, against 10
                 uninterrupted: logged losses equal, step-9 checkpoints
                 equal byte for byte; (t2) minicpm-2b at its published
                 widths (40 layers, 2.72 B params, f32 masters, bf16
                 activations, remat full, WSD), one 4 x 512 batch for 6
                 steps, the state updated in place, the first eager and
                 the rest replays: losses finite and falling, step ms,
                 tokens/s, model TFLOP/s, optimizer ms (the eager first
                 step's), launches, busy share and top device ops of one
                 replay, peak and pool GB, and a ``cast_params`` step
                 within 0.02 of the
                 f32-compute loss; (t3b) that state saved asynchronously
                 (the loop's blocked ms, the write's seconds) and restored
                 bit-equal.  No kernel of ``csrc/`` is on this path.
   ``train_mesh`` the mesh train step, in a child process (``python3
                 chip_smoke.py --train-mesh``) whose rank processes
                 (``--train-mesh-rank``) share the card over gloo: (tm1)
                 qwen2.5-14b and mixtral-8x22b SMOKE on
                 ``data=2,model=2`` (four ranks), qwen2.5-14b with
                 ``tp_psum`` on ``model=2`` and minicpm-2b with
                 ``microbatches=2`` and mixtral-8x22b (its whole
                 microbatch routed) on ``data=2`` (two), f32, three steps
                 each against the one-device computation of the step on
                 the card (the CPU limits), the state gathered whole
                 bit-equal across ranks; every rank holds its part of
                 the state (the reference's placement: its bytes equal
                 the placed bytes); (tm3) mixtral-8x22b at its widths, 1
                 layer, f32, expert-parallel on ``model=2``: the loss,
                 every gradient leaf and one step's grad_norm and params
                 against one device, state and peak GB a rank, the
                 gathers' and the reduce's bytes and ms; (tm2) minicpm-2b
                 at its widths, 4 of 40 layers, on ``data=2``: 2 steps of
                 4 x 512 tokens, step 1's loss and grad_norm against one
                 device, step ms, tokens/s, step 1's gathers' and
                 reduce's bytes and ms, peak GB a rank.  No kernel of
                 ``csrc/`` is on this path.
   ``dryrun``    the dry-run (``repro_torch.launch.dryrun``).  In a
                 process of their own (``--dryrun-cell``, at a low
                 priority) started after the build, beside the phases
                 before this one (they trace on the host, on fake
                 tensors): (d1) the qwen2.5-14b x train_4k x single cell
                 counted at rank 0 of the 16x16 mesh's fake group of 256
                 ranks on fake cuda tensors: the record, its traces'
                 seconds and depths, and the rank's argument bytes (its
                 part of the state: equal to ``argument_size_if_placed``)
                 beside the card's 80 GB and the reference's committed
                 record of the cell; (d4) the qwen2.5-14b x decode_32k
                 cell the same way (the partitioned serving program):
                 argument bytes equal to the placed bytes and to the
                 reference's, FLOPs a rank within 1.25 x the
                 reference's; (d3) minicpm-2b at its widths,
                 4 layers, 2 microbatches of 1 x 512: the counts weighed
                 from the traced depths equal the step traced whole;
                 (d2)'s fake counts.  Then, in this process (``python3
                 chip_smoke.py --dryrun`` runs the whole phase alone),
                 (d2) minicpm-2b, 2 layers, one 1 x 512 train step on
                 one device (3.4 GB, freed after): FLOPs, HBM bytes and
                 collective bytes of the step's eager body (what its
                 graph records; a replay issues no op) counted on real
                 cuda tensors equal the dry-run's on fake cuda ones
                 (FLOPs on fake cpu ones too), the captured step's
                 median ms beside the record's bound.
                 No kernel of ``csrc/`` is on this path.
3. ``check``     each kernel against its plain torch version on the card,
                 at the main path's shapes and the edges of each kernel's
                 plan (paths, K splits, ragged and unaligned shapes);
                 fused_matmul_q8's int32-sums mode at VGG19 dense_41's
                 row shard under model=2 and at M=1.
4. ``main``      the six Table-1 CNNs through ``repro_torch.compile(...,
                 target="cuda")`` at batch 1 and 256: ``exact`` against
                 ``interpret`` on the card, ``fast`` against the same
                 compile on the CPU (path 1); ``int8``/``bf16`` against
                 ``jit`` (path A); decode attention at qwen2.5-14b's
                 widths (path B).  Each path sets the wrappers' counts
                 to 0, prepares its programs (a warm-up call and a
                 captured call each, both through the wrappers, which
                 count them), then calls each program once under
                 ``torch.profiler``: a replay passes through no wrapper,
                 so its launches are counted from the kernel names, and
                 held against the graphs' dense and softmax nodes.
5. ``program``   every captured program of paths 1, A and B against the
                 eager program it was captured from: bit-equal on two
                 different inputs, the first call's outputs unchanged by
                 the second (fresh clones), and the launches of one
                 replay from the profiler; capture time and the graph
                 pool's bytes per program.
                 ``split_counters``: a captured program still replays
                 bit-equal after its split counters grew and after a
                 larger plan was captured.
6. ``runtime``   batch buckets: ``buckets=BucketPolicy`` (the engine
                 cache, a bucket captured in the background while a
                 warm one serves) and the legacy ``batch_buckets``, each
                 output bit-equal to the bucket's program on the padded
                 input and close to ``interpret``.
7. ``cache``     ``serialize``/``deserialize`` bit-equal, and a second
                 process that takes every program's entry from the
                 executable cache, runs no pass pipeline and gives the
                 first process's outputs bit for bit.
8. ``pool``      one graph pool per executable: VGG19 exact at 8 batch
                 sizes between 129 and 256, the largest first: the
                 growth of ``memory_reserved`` within the batch-256
                 pool plus the static inputs and outputs (+10%), beside
                 what 8 private pools take; replays in reverse and
                 shuffled order bit-equal to the eager walk; the same in
                 ascending order, and in a child process whose allocator
                 rounds requests to half powers of two (reported); the pool
                 bytes of paths 1, A and B.
9. ``autotune``  every tactic grid point of B1, B2 and B4 against its
                 plain version at the main path's shapes; C-HTWK and
                 VGG19 at exact and int8 (batch 1 and 256) and path B's
                 decode node (batch 8) with ``autotune="full"``: each
                 node's candidates in device µs and its winner, each
                 graph decision's, every tuned program within its path's
                 bound of ``interpret`` and bit-equal to its eager walk,
                 tuned against heuristic time; a second process with
                 ``autotune="cached"`` measures nothing and matches bit
                 for bit.
10. ``mixed``    ``precision="mixed"`` for C-HTWK, C-BH and VGG19 (batch 1
                 and 256): per-site candidates, errors and winners, each
                 within budget, the median example within the path-A
                 budget of ``interpret``; seeded all-int8 and all-f32
                 winners bit-equal to the int8 and f32 programs.
11. ``frontends`` C-HTWK and VGG19 written as functions over
                 ``repro_torch.frontends.ops`` and traced, at exact and
                 fast (batch 1 and 256) and C-HTWK at int8 (batch 256);
                 ``ops.decode_attention`` at path B's widths (batch 1);
                 both models compiled from an ``.npz`` path, a
                 ModelBuilder without ``.build()`` and a bare callable
                 with ``example_inputs=`` on the card: each bit-equal to
                 the main path's program, each replay's launches (the
                 profiler's) equal to that program's.
12. ``replay``   capture bundles of VGG19 exact and C-HTWK int8 with
                 ``autotune="full"`` (batch 256 then 1) in
                 ``chiprun_out/bundles``, each replayed by ``python -m
                 repro_torch.replay --json`` in a fresh process (exit 0,
                 bit-exact, selections and tactics equal); a copy with a
                 byte of ``io.npz`` flipped exits 2.  Bundle bytes, the
                 record's seconds per batch, the replay's seconds.
13. ``time``     medians of interpret/jit/cuda per model and batch (host
                 clock around a synchronised call), captured and eager,
                 with the device's busy time per inference, exact and
                 fast (``torch.profiler``, which sees the kernels inside
                 a graph replay by name); per kernel at the
                 main-path shapes its time, the plain version's, a library
                 call's and the bound.  A kernel row's ``ms``,
                 ``plain_ms`` and ``library_ms`` are the median device time
                 of one call with the L2 flushed before it (CUDA events
                 around the call, queued while the flush runs, so the
                 host's launch cost drops out); ``call_ms`` is the time per
                 call over back-to-back calls of the Python wrapper, which
                 the host's launch cost sets.

Then the ``{"kernels": [...]}`` line, and last the ``{"ok": true, ...}``
line.  Any failure exits non-zero before the ``ok`` line; without CUDA
it exits 2 at once.
"""

from __future__ import annotations

import collections
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM peaks used for the bound (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # f32 outside the tensor cores
INT8_OPS_PER_S = 1979e12         # int8 tensor-core peak, dense
MATMUL_ATOL = 1e-4               # kernel vs plain: f32 sums in another order
EXACT_ATOL = 1e-4                # cuda exact vs interpret on the card
FAST_ATOL = 1e-5                 # cuda fast on the card vs on the CPU
#: fused_matmul_q8 vs plain for elu/tanh/sigmoid: CUDA's expm1f/tanhf/
#: expf against torch's, an ulp or so below 1; the other epilogues are
#: held bit-equal (exact int32 sum, the same rounded f32 operations).
Q8_ATOL = 1e-6
Q8_BIT_EQUAL = ("none", "relu", "leaky_relu", "relu_affine")
#: decode_attention vs its plain forms: f32 sums over up to 32768 rows in
#: another order, with outputs of unit-normal V below ~5.
DECODE_ATOL = 1e-5
#: The reference's default accuracy budget (repro quantize.py:64), a
#: per-site limit on 4 calibration rows.  Against interpret exact, the
#: median example's max abs error is held to it, scaled by the output's
#: magnitude where that exceeds 1; the tails exceed it in the reference
#: itself (CPU: C-HTWK int8 0.082 at batch 256, in 2 of 256 examples;
#: MobileNetV2 bf16, outputs up to ~4, 0.077 at batch 8).
QUANT_BUDGET = 0.05
BF16_ATOL = 1e-4                 # cuda bf16 vs jit bf16: f32 sums reordered
BATCHES = (1, 256)
#: The order programs are prepared in: the largest batch first, the
#: layout of an executable's graph pool, so that no program is captured
#: again (a larger batch after a smaller one recaptures it, which the
#: wrappers would count).
PREPARE = tuple(sorted(BATCHES, reverse=True))
#: The Table-1 graphs with dense nodes: the int8 path's graphs.
INT8_MODELS = ("C-HTWK", "C-BH", "VGG19")
#: qwen2.5-14b's attention widths (src/repro/configs/qwen2_5_14b.py) over
#: the KV depth of decode_32k (src/repro/configs/base.py), its batch of
#: 128 cut to 8: K and V in f32 take 2.15 GB on the card.
DECODE = {"h": 40, "hkv": 8, "d": 128, "s": 32768}
DECODE_LENGTHS = {1: [31000],
                  8: [32768, 32767, 30000, 16385, 12345, 4097, 1000, 513]}
#: (B, H, Hkv, D, S, lengths) checked beside the path's shape: the largest
#: group and head dim (recurrentgemma-9b's G 16, D 256), no grouping, and
#: a head dim that is not a multiple of 4 (the kernel's scalar loads).
DECODE_CHECK_MORE = [(2, 16, 1, 256, 4096, [4096, 1537]),
                     (2, 36, 36, 64, 4096, [3001, 4096]),
                     (2, 6, 2, 100, 1500, [1500, 777]),
                     # Two tiles a chunk (kernel.py::chunk_plan) over an S
                     # that is no multiple of the chunk: lengths on a chunk
                     # edge, inside the first tile, 1, and S.
                     (4, 40, 8, 128, 9000, [2048, 300, 1, 9000])]
KERNELS = ("fused_matmul", "fast_act", "fused_matmul_q8", "decode_attention")
#: Calls of the eager program that preparing one captured program makes,
#: each through the wrappers: the warm-up and the captured call
#: (``core/program.py``).
PREPARE_CALLS = 2
#: The most times ``profiled_call`` profiles one call (it stops once two
#: profiles in a row agree).
PROFILE_TRIES = 6
#: The CUDA kernels of each wrapper by symbol (``csrc/``), to count the
#: launches on the card from the profiler's kernel names.
#: decode_attention counts calls: its combine kernel runs once per call.
KERNEL_SYMBOLS = {
    "fused_matmul": ("fm_gemv_kernel<", "fm_tiled_kernel<"),
    "fused_matmul_q8": ("q8_gemv_oi_kernel<", "q8_gemv_io_kernel<",
                        "q8_tiled_kernel<"),
    "fast_act": ("fast_act_kernel<",),
    "decode_attention": ("combine_kernel",),
}
#: The runtime phase: a bucket policy over the main path's batches, the
#: batches sent through it, and the legacy batch_buckets.
RUNTIME_POLICY = (1, 4, 16, 64, 256)
RUNTIME_BATCHES = (1, 3, 17, 100, 256)
RUNTIME_MODELS = ("VGG19", "C-HTWK")
LEGACY_BUCKETS = (4, 256)
#: The cache phase's compiles, made again by a second process.
CACHE_COMPILES = (("C-HTWK", "int8"), ("VGG19", "exact"))
TIMED_RUNS = 25
DEVICE = "cuda"

_OUT = []
_EMIT_LOCK = threading.Lock()


def emit(obj) -> None:
    line = json.dumps(obj)
    with _EMIT_LOCK:                  # a phase may emit from a thread
        _OUT.append(line)
        print(line, flush=True)


def save_log() -> None:
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.jsonl"), "w") as f:
        f.write("\n".join(_OUT) + "\n")


def cuda_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back launches,
    between CUDA events, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_median_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median wall time of ``fn()`` ending in a synchronise."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def cold_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` call from a cold L2: before each
    call a 256 MB write evicts the card's 50 MB L2 (leaving it dirty, so
    the call also pays for write-backs, as it would in a model), and a
    spin gives the host time to queue the call behind it; CUDA events
    bracket the call alone."""
    import torch
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for start, end in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(starts, ends))


def queued_ms(fn, iters: int = 50, spin: int = 40_000_000) -> float:
    """Device time per call of ``fn()`` with the host out of the way:
    the card first spins for ``spin`` cycles (``torch.cuda._sleep``;
    40M is ~20 ms) while the host queues ``iters`` calls, so the CUDA
    events time the calls' work back to back, without the host's launch
    gaps.  The host must queue all calls within the spin."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int = 20):
    """Each CUDA kernel ``fn()`` launched, by name, from ``torch.profiler``
    over ``iters`` calls: (launches per call, device ms per call).  The
    profiler sees the kernels inside a CUDA graph replay by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        t = getattr(evt, "self_device_time_total", None)
        t = t if t is not None else getattr(evt, "self_cuda_time_total", 0.0)
        n, ms = out.get(evt.key, (0.0, 0.0))
        out[evt.key] = (n + evt.count / iters, ms + t / iters / 1e3)
    return out


def device_ms_by_kernel(fn, iters: int = 20):
    """Device time per call of ``fn()`` of each CUDA kernel it launched,
    by name, from ``torch.profiler`` over ``iters`` calls."""
    return {k: ms for k, (_, ms) in device_profile(fn, iters).items() if ms}


def device_ms(fn, iters: int = 20):
    """Device time per call of ``fn()``: the sum of every CUDA kernel it
    launched; None when the profiler recorded no device time twice (a
    profile now and then comes back empty)."""
    total = sum(device_ms_by_kernel(fn, iters).values())
    total = total or sum(device_ms_by_kernel(fn, iters).values())
    return total or None


def profiled_call(fn):
    """``fn()``, a replay of captured programs, under ``torch.profiler``,
    synchronised: its result and the launches on the card of each
    wrapper's kernels, counted from the kernel names (KERNEL_SYMBOLS),
    inside graph replays too.  Now and then a profile comes back empty,
    or with the call's copies and only part of its replay's kernels,
    while the outputs show the replay ran.  A replay launches the same
    kernels at every call, so the call is profiled again until two
    profiles in a row hold kernels and agree, kernel by kernel (at most
    PROFILE_TRIES times; a replay that launched other kernels at each
    call would never agree, and its last profile is returned)."""
    prev = None
    for _ in range(PROFILE_TRIES):
        out, counts, kernels = _profile_once(fn)
        if kernels and kernels == prev:
            break
        prev = kernels
    return out, counts


def _profile_once(fn):
    """``fn()`` under ``torch.profiler``, synchronised, once: its result,
    each wrapper's kernel launches (KERNEL_SYMBOLS) and every kernel's
    launches by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    counts = {k: 0 for k in KERNELS}
    kernels = collections.Counter()
    for evt in prof.key_averages():
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        if not evt.key.startswith(("Memcpy", "Memset")):
            kernels[evt.key] += evt.count
        for kernel, symbols in KERNEL_SYMBOLS.items():
            if any(sym in evt.key for sym in symbols):
                counts[kernel] += evt.count
    return out, counts, kernels


def eager_call(exe, feeds):
    """The outputs of the eager program (the LoweredGraph walk) that
    ``exe``'s program for this batch was captured from, on ``feeds``,
    keyed like ``exe(**feeds)``."""
    import torch
    env = {n: torch.as_tensor(feeds[n], device=DEVICE) for n in exe.graph.inputs}
    batch = next(iter(env.values())).shape[0]
    prog = exe.ensure_compiled(batch)
    with torch.inference_mode():
        out = getattr(prog, "eager", prog)(env)   # the CPU's is eager
    return {pub: out[opt]
            for pub, opt in zip(exe.source.output_names, exe.graph.outputs)}


def outputs_equal(a, b) -> bool:
    import torch
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def bound_ms(nbytes: float, flops: float, ops_per_s: float = F32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def counters():
    """The launch counters of every kernel wrapper, by kernel name."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.fast_act.ops import fast_act
    from repro_torch.kernels.fused_matmul.ops import (fused_matmul,
                                                      fused_matmul_q8)
    return {"fused_matmul": fused_matmul, "fast_act": fast_act,
            "fused_matmul_q8": fused_matmul_q8,
            "decode_attention": decode_attention}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


# ---------------------------------------------------------------------------
def phase_card(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit({"phase": "card", "nvidia_smi": line,
          "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return line


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    lib = build.build()
    seconds = time.perf_counter() - t0
    build.load()
    log = lib.with_suffix(".log").read_text() if lib.with_suffix(".log").exists() else ""
    ptxas = [l.strip() for l in log.splitlines()
             if "registers" in l or "Compiling entry" in l or "spill" in l]
    emit({"phase": "build", "seconds": round(seconds, 3),
          "library": os.path.relpath(str(lib), ROOT), "ptxas": ptxas})


MAIN_DENSE_KN = [(128, 16), (16, 4), (256, 32), (32, 2), (256, 128),
                 (128, 128), (128, 10)]
#: B1 shapes beside the main path's (which hold M 1 and 256 at K 256),
#: each taking a path of its plan: the GEMV path's edge (M 16) and the
#: tiled path's (M 17), a ragged one, and deep K split across blocks.
#: Their tolerance is MATMUL_ATOL scaled by sqrt(K / 256): unit-normal
#: sums of K terms in another order.
DENSE_CHECK_MORE = [(16, 256, 128), (17, 256, 128), (300, 257, 130),
                    (256, 2048, 128), (1, 2048, 96)]
#: B2 shapes beside the int8 path's (M 1 and 256 at MAIN_DENSE_KN), each
#: on a path of plan_q8 or its edge: M 1/16 (GEMV) and 17/33 (tiled) at
#: K 256 N 128, K 16 and 32 (below the s8 mma's depth of 32, and at it)
#: over a full N, deep K split across blocks on both paths, and a ragged
#: shape with odd K and N (element copies, no 16-byte loads).
Q8_CHECK_MORE = [(1, 256, 128), (16, 256, 128), (17, 256, 128),
                 (33, 256, 128), (256, 16, 128), (256, 32, 128),
                 (256, 2048, 128), (1, 2048, 96), (300, 257, 130)]
EPILOGUES = [  # (name, fn, fast, attrs, affine)
    ("none", None, False, {}, False),
    ("relu", "relu", False, {}, False),
    ("leaky_relu", "leaky_relu", False, {"alpha": 0.1}, False),
    ("elu", "elu", False, {}, False),
    ("tanh", "tanh", False, {}, False),
    ("tanh_fast", "tanh", True, {}, False),
    ("sigmoid", "sigmoid", False, {}, False),
    ("sigmoid_fast", "sigmoid", True, {}, False),
    ("relu_affine", "relu", False, {}, True),
]


def phase_check(torch, np):
    from repro_torch.kernels.fused_matmul import kernel as fm_k
    from repro_torch.kernels.fused_matmul import ref as fm_ref
    from repro_torch.kernels.fused_matmul.ops import fused_matmul

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(11)
    shapes = [(m, k, n) for k, n in MAIN_DENSE_KN for m in BATCHES]
    shapes += DENSE_CHECK_MORE
    worst, failures, cases, plans = 0.0, [], 0, {}
    split_worst, deterministic = 0.0, True
    for m, k, n in shapes:
        atol = MATMUL_ATOL * max(1.0, (k / 256) ** 0.5)
        x32 = torch.tensor(rng.standard_normal((m, k)), dtype=torch.float32,
                           device=dev)
        wio = torch.tensor(rng.standard_normal((k, n)), dtype=torch.float32,
                           device=dev)
        bias = torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                            device=dev)
        scale = torch.tensor(rng.uniform(0.5, 1.5, n), dtype=torch.float32,
                             device=dev)
        offset = torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                              device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for layout in ("io", "oi"):
                w = (wio if layout == "io" else wio.T.contiguous()).to(dtype)
                p = fm_k.plan(m, k, n, w_layout=layout,
                              itemsize=x.element_size())
                plans[f"{m}x{k}x{n} {layout}"] = p.describe()
                for name, fn, fast, attrs, affine in EPILOGUES:
                    s, o = (scale, offset) if affine else (None, None)
                    got = fused_matmul(x, w, bias, s, o, fn=fn, fast=fast,
                                       w_layout=layout, attrs=attrs)
                    want = fm_ref.fused_matmul_ref(
                        x.float(), w.float(), bias, s, o, fn=fn, fast=fast,
                        w_layout=layout, attrs=attrs)
                    err = float((got - want).abs().max())
                    cases += 1
                    worst = max(worst, err)
                    ok = err <= atol
                    if name == "relu_affine":
                        # The split reduction: against its plain emulation,
                        # and bit-equal from one call to the next.
                        split = fm_ref.fused_matmul_split_ref(
                            x.float(), w.float(), bias, s, o, fn=fn,
                            w_layout=layout, splits=p.splits, ksplit=p.ksplit)
                        split_worst = max(split_worst,
                                          float((got - split).abs().max()))
                        again = fused_matmul(x, w, bias, s, o, fn=fn,
                                             w_layout=layout)
                        same = bool(torch.equal(got, again))
                        deterministic &= same
                        ok &= same
                    if not ok:
                        failures.append([m, k, n, str(dtype), layout, name, err])
    torch.cuda.synchronize()
    emit({"phase": "check", "kernel": "fused_matmul", "cases": cases,
          "max_abs_err": worst, "atol": MATMUL_ATOL,
          "atol_deep_k": "MATMUL_ATOL * sqrt(K / 256) for K > 256",
          "max_abs_err_vs_split_ref": split_worst,
          "deterministic_two_calls": deterministic,
          "inputs": "unit-normal x and W, f32 accumulation, TF32 off",
          "plans": plans, "failures": failures[:20]})
    fm_err = worst

    fa_worst, fa_fail = 0.0, []
    for fn in ("exp", "tanh", "sigmoid"):
        row = fast_act_check(torch, np, fn, rng)
        fa_worst = max(fa_worst, row["f32_max_abs_err"])
        if not row["ok"]:
            fa_fail.append(fn)
        emit(row)
    torch.cuda.synchronize()
    problems = []
    if failures or fa_fail:
        problems.append(f"kernel checks failed: fused_matmul {len(failures)} "
                        f"cases, fast_act {fa_fail}")
    return fm_err, fa_worst, problems


def fast_act_check(torch, np, fn, rng):
    """fast_act against its plain version on the card: the main path's
    largest input size (4097 x 1000 + 3, through -120..120 and unit
    normals x 5), every length 1..37 (scalar head and tail around the
    16-byte vectors), and a view starting one element into its storage
    (``x.view(-1)[1:]``, which the wrapper takes as contiguous); f32
    bit-equal, bf16 equal."""
    from repro_torch.kernels.fast_act import ref as fa_ref
    from repro_torch.kernels.fast_act.ops import fast_act

    dev = torch.device(DEVICE)
    big = torch.tensor(rng.standard_normal(4097 * 1000 + 3) * 5.0,
                       dtype=torch.float32, device=dev)
    big[:241] = torch.linspace(-120.0, 120.0, 241, device=dev)
    cases = [("4097x1000+3", big),
             ("view[1:] of 4097x1000+3", big.view(-1)[1:])]
    cases += [(f"n={n}", big[:n].clone()) for n in range(1, 38)]
    cases += [(f"view[1:] n={n}", big[:n + 1].clone().view(-1)[1:])
              for n in (1, 7, 8, 9, 37)]
    ulps_max, err_max, f32_equal, bf16_equal = 0, 0.0, True, True
    for _, x in cases:
        got = fast_act(x, fn)
        want = fa_ref.FAST[fn](x)
        ulps_max = max(ulps_max, int((got.view(torch.int32).long()
                                      - want.view(torch.int32).long())
                                     .abs().max()))
        err_max = max(err_max, float((got - want).abs().max()))
        f32_equal &= bool(torch.equal(got, want))
        xb = x.to(torch.bfloat16) if x.data_ptr() % 16 == 0 else \
            torch.empty(x.numel() + 1, dtype=torch.bfloat16,
                        device=dev)[1:].copy_(x)
        wantb = fa_ref.FAST[fn](xb.float()).to(torch.bfloat16)
        bf16_equal &= bool(torch.equal(fast_act(xb, fn), wantb))
    torch.cuda.synchronize()
    return {"phase": "check", "kernel": "fast_act", "fn": fn,
            "cases": [c for c, _ in cases[:2]] + ["n=1..37",
                                                  "view[1:] n=1,7,8,9,37"],
            "f32_max_ulps": ulps_max, "f32_bit_equal": f32_equal,
            "f32_max_abs_err": err_max, "bf16_equal": bf16_equal,
            "ok": f32_equal and bf16_equal}


#: The int32-sums mode's shapes: VGG19 dense_41's row shard under
#: model=2 (K 128 over 2 ranks), at batch 256 and 1.
Q8_SUMS_SHAPES = [(256, 64, 128), (1, 64, 128)]


def phase_check_q8(torch, np):
    """fused_matmul_q8 against its plain version at the int8 path's shapes
    and a ragged one, both layouts, every epilogue; then its quantize of
    ``x`` against ``quantize_q8`` on inputs placed exactly on .5 ties."""
    from repro_torch.kernels import qmath
    from repro_torch.kernels.fused_matmul import ref as fm_ref
    from repro_torch.kernels.fused_matmul.ops import fused_matmul_q8

    from repro_torch.kernels.fused_matmul import kernel as fm_k

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(12)
    shapes = [(m, k, n) for k, n in MAIN_DENSE_KN for m in BATCHES]
    shapes += Q8_CHECK_MORE
    worst, failures, cases, equal_cases = 0.0, [], 0, 0
    plans, deterministic, split_equal = {}, True, True
    for m, k, n in shapes:
        x_np = rng.standard_normal((m, k)).astype(np.float32)
        w_np = rng.standard_normal((k, n)).astype(np.float32)
        x = torch.from_numpy(x_np).to(dev)
        xs = qmath.tensor_scale(float(np.abs(x_np).max()) * 0.8)  # some clip
        ws = qmath.channel_scales(w_np, 1)
        vec = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
        bias = vec(rng.standard_normal(n))
        scale = vec(rng.uniform(0.5, 1.5, n))
        offset = vec(rng.standard_normal(n))
        xq = qmath.quantize_q8(x, xs)
        for layout in ("io", "oi"):
            w = torch.from_numpy(w_np if layout == "io"
                                 else np.ascontiguousarray(w_np.T)).to(dev)
            wq, deq = qmath.quantize_weight(w, xs, ws, layout)
            p = fm_k.plan_q8(m, k, n, w_layout=layout)
            plans[f"{m}x{k}x{n} {layout}"] = p.describe()
            for name, fn, fast, attrs, affine in EPILOGUES:
                s, o = (scale, offset) if affine else (None, None)
                kw = dict(fn=fn, fast=fast, w_layout=layout, attrs=attrs)
                got = fused_matmul_q8(x, wq, deq, bias, s, o, x_scale=xs, **kw)
                want = fm_ref.fused_matmul_q8_ref(xq, wq, deq, bias, s, o, **kw)
                err = float((got - want).abs().max())
                equal = bool(torch.equal(got, want))
                cases += 1
                equal_cases += equal
                worst = max(worst, err)
                ok = equal if name in Q8_BIT_EQUAL else err <= Q8_ATOL
                if name == "relu_affine":
                    # The split reduction: bit-equal to its plain int32
                    # emulation, and from one call to the next.
                    split = fm_ref.fused_matmul_q8_split_ref(
                        xq, wq, deq, bias, s, o, splits=p.splits,
                        ksplit=p.ksplit, **kw)
                    same_split = bool(torch.equal(got, split))
                    same = bool(torch.equal(got, fused_matmul_q8(
                        x, wq, deq, bias, s, o, x_scale=xs, **kw)))
                    split_equal &= same_split
                    deterministic &= same
                    ok &= same and same_split
                if not ok:
                    failures.append([m, k, n, layout, name, err, equal])
    torch.cuda.synchronize()

    # The kernel's quantize of x, read through an identity W and deq = 1:
    # out = float(q(x)).  Ties of x / s in f32, for a scale that is not a
    # power of two and for one that is, then random values.
    tie_rows, tie_ok, n_ties = [], True, 0
    for s in (np.float32(0.1), np.float32(0.25)):
        half = np.arange(-140, 140) + 0.5
        cand = (half * s).astype(np.float32)
        ties = cand[(cand / s) == half]
        n_ties += len(ties)
        vals = np.concatenate([ties, rng.standard_normal(64).astype(np.float32)
                               * np.float32(40.0) * s])
        xt = torch.from_numpy(vals[None, :]).to(dev)
        t = vals.shape[0]
        eye = torch.eye(t, dtype=torch.int8, device=dev)
        ones = torch.ones(t, dtype=torch.float32, device=dev)
        got = fused_matmul_q8(xt, eye, ones, x_scale=float(s))
        want = qmath.quantize_q8(xt, float(s)).float()
        numpy_half_even = np.clip(np.round(vals / s), -127, 127)
        ok = (bool(torch.equal(got, want))
              and np.array_equal(want.cpu().numpy()[0], numpy_half_even))
        tie_ok &= ok
        tie_rows.append({"scale": float(s), "ties": int(len(ties)),
                         "values": int(t), "equal": ok})
    # The int32-sums mode (a row-parallel site of a sharded compile): at
    # VGG19 dense_41's row shard under model=2 and at M=1, bit-equal to
    # its plain version and across two calls.
    sums_rows, sums_ok = [], True
    for m, k, n in Q8_SUMS_SHAPES:
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(
            np.float32)).to(dev)
        for layout in ("io", "oi"):
            wq = torch.from_numpy(rng.integers(
                -127, 128, (k, n) if layout == "io" else (n, k),
                dtype=np.int8)).to(dev)
            got = fused_matmul_q8(x, wq, None, x_scale=0.02, w_layout=layout,
                                  sums=True)
            again = fused_matmul_q8(x, wq, None, x_scale=0.02,
                                    w_layout=layout, sums=True)
            want = fm_ref.q8_sums_ref(qmath.quantize_q8(x, 0.02), wq,
                                      w_layout=layout)
            ok = bool(torch.equal(got, want) and torch.equal(got, again)
                      and got.dtype == torch.int32)
            sums_ok &= ok
            sums_rows.append({"M": m, "K": k, "N": n, "layout": layout,
                              "bit_equal": ok,
                              "plan": fm_k.plan_q8(m, k, n, w_layout=layout)
                              .describe()})
    emit({"phase": "check", "kernel": "fused_matmul_q8", "cases": cases,
          "int32_sums_mode": sums_rows,
          "bit_equal_cases": equal_cases, "max_abs_err": worst,
          "bit_equal_for": list(Q8_BIT_EQUAL), "atol_others": Q8_ATOL,
          "bit_equal_to_split_ref": split_equal,
          "deterministic_two_calls": deterministic,
          "inputs": "unit-normal x and W, x scale clipping 20% of |x|max",
          "quantize_ties": tie_rows, "plans": plans,
          "failures": failures[:20]})
    problems = []
    if failures or not tie_ok or not n_ties or not sums_ok:
        problems.append(f"fused_matmul_q8 checks failed: {len(failures)} "
                        f"cases, quantize ties equal: {tie_ok}, int32 "
                        f"sums mode equal: {sums_ok}")
    return worst, problems


def decode_inputs(torch, b, h, hkv, d, s, lengths, seed):
    """q (b, h, d) and K/V (b, s, hkv, d), unit normal, made on the card
    from ``seed``; lengths (b,) int32."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn((b, h, d), generator=gen, device=DEVICE)
    k = torch.randn((b, s, hkv, d), generator=gen, device=DEVICE)
    v = torch.randn((b, s, hkv, d), generator=gen, device=DEVICE)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
    return q, k, v, lens


def phase_check_decode(torch, np):
    """decode_attention against its tiled plain form and its split
    emulation (the kernels' own algorithm), exact and fast, and against
    the one-pass form, exact: qwen2.5-14b's widths over the 32768-deep
    cache at batch 8, then the largest group (H 16, Hkv 1, D 256), no
    grouping at D 64 (H 36, Hkv 36), D 100 (scalar loads), and lengths
    on the chunk plan's edges.  Two calls on the same inputs must be
    bit-equal."""
    from repro_torch.kernels.decode_attention import kernel as attn_k
    from repro_torch.kernels.decode_attention import ref as attn_ref
    from repro_torch.kernels.decode_attention.ops import decode_attention

    shapes = [(8, DECODE["h"], DECODE["hkv"], DECODE["d"], DECODE["s"],
               DECODE_LENGTHS[8])] + DECODE_CHECK_MORE
    worst, failures = 0.0, []
    for i, (b, h, hkv, d, s, lengths) in enumerate(shapes):
        q, k, v, lens = decode_inputs(torch, b, h, hkv, d, s, lengths, 20 + i)
        tpc, chunks = attn_k.chunk_plan(b, hkv, s)
        errs, deterministic = {}, True
        for fast in (False, True):
            got = decode_attention(q, k, v, lens, fast=fast)
            deterministic &= bool(torch.equal(
                got, decode_attention(q, k, v, lens, fast=fast)))
            want = attn_ref.decode_attention_tiled(q, k, v, lens, fast=fast)
            tag = "fast" if fast else "exact"
            errs[f"{tag}_vs_tiled"] = float((got - want).abs().max())
            split = attn_ref.decode_attention_split(
                q, k, v, lens, tiles_per_chunk=tpc, fast=fast)
            errs[f"{tag}_vs_split"] = float((got - split).abs().max())
            if not fast:
                one = attn_ref.decode_attention_ref(q, k, v, lens)
                errs["exact_vs_one_pass"] = float((got - one).abs().max())
        torch.cuda.synchronize()
        # Masking: rows past a length must not matter.
        k2, v2 = k.clone(), v.clone()
        for bi, n in enumerate(lengths):
            k2[bi, n:] = 1e4
            v2[bi, n:] = float("nan")
        masked_equal = bool(torch.equal(decode_attention(q, k2, v2, lens),
                                        decode_attention(q, k, v, lens)))
        del k2, v2
        worst = max(worst, *errs.values())
        ok = (all(e <= DECODE_ATOL for e in errs.values()) and masked_equal
              and deterministic)
        if not ok:
            failures.append([b, h, hkv, d, s, errs, masked_equal,
                             deterministic])
        emit({"phase": "check", "kernel": "decode_attention",
              "shape": {"B": b, "H": h, "Hkv": hkv, "D": d, "S": s},
              "lengths": lengths, "plan": {"tiles_per_chunk": tpc,
                                           "chunks": chunks},
              "max_abs_err": errs, "atol": DECODE_ATOL,
              "rows_past_length_ignored": masked_equal,
              "deterministic_two_calls": deterministic, "ok": ok})
    problems = []
    if failures:
        problems.append(f"decode_attention checks failed: {failures}")
    return worst, problems


def expected_launches(graph):
    """Kernel launches per inference, read off the source graph and not
    off the selector: one ``fused_matmul`` per dense node, and under
    ``precision="fast"`` one ``fast_act`` (its exp) per softmax node --
    the Table-1 graphs' only activations with a fast_act form."""
    return (sum(n.op == "dense" for n in graph.nodes),
            sum(n.op == "softmax" for n in graph.nodes))


def phase_main(torch, np):
    import repro_torch
    from repro_torch.table1_models import SUITE

    rng = np.random.default_rng(0)
    exes, inputs, failures, expect = {}, {}, [], {}
    for name, build_graph in SUITE.items():
        g = build_graph()
        expect[name] = expected_launches(g)
        for prec in ("exact", "fast"):
            exes[name, "cuda", prec] = repro_torch.compile(
                g, repro_torch.CompileOptions(target="cuda", precision=prec,
                                              device=DEVICE))
        exes[name, "interpret", "exact"] = repro_torch.compile(
            g, repro_torch.CompileOptions(target="interpret", device=DEVICE))
        exes[name, "jit", "exact"] = repro_torch.compile(
            g, repro_torch.CompileOptions(target="jit", device=DEVICE))
        exes[name, "cpu", "fast"] = repro_torch.compile(
            g, repro_torch.CompileOptions(target="cuda", precision="fast",
                                          device="cpu"))
        for b in BATCHES:
            inputs[name, b] = rng.standard_normal(
                (b,) + tuple(g.inputs["input"].shape)).astype(np.float32)

    # The path, every count set to 0 just before and read just after:
    # each batch size's program prepared (a warm-up and a captured call
    # through the wrappers), then called once under the profiler, which
    # counts the replay's kernels by name.
    reset_counts()
    for name in SUITE:
        for prec in ("exact", "fast"):
            for b in PREPARE:
                exes[name, "cuda", prec].ensure_compiled(b)
    torch.cuda.synchronize()
    prepared = read_counts()
    outs = {}
    expect_total = {k: 0 for k in KERNELS}
    launches = {k: 0 for k in KERNELS}
    per_model = {}
    for name in SUITE:
        for b in BATCHES:
            for prec in ("exact", "fast"):
                exe = exes[name, "cuda", prec]
                out, counts = profiled_call(
                    lambda: exe(input=inputs[name, b]))
                outs[name, b, prec] = out
                n_fm, n_fa = expect[name]
                n_fa = n_fa if prec == "fast" else 0
                expect_total["fused_matmul"] += n_fm
                expect_total["fast_act"] += n_fa
                for k in KERNELS:
                    launches[k] += counts[k]
                per_model[name, b, prec] = dict(
                    counts, expected={"fused_matmul": n_fm, "fast_act": n_fa,
                                      "fused_matmul_q8": 0,
                                      "decode_attention": 0})
    wrappers = read_counts()

    for name in SUITE:
        for b in BATCHES:
            x = inputs[name, b]
            want = exes[name, "interpret", "exact"](input=x)
            got = outs[name, b, "exact"]
            err_exact = max(float((got[k] - want[k]).abs().max()) for k in want)
            want_f = exes[name, "cpu", "fast"](input=x)
            got_f = outs[name, b, "fast"]
            err_fast = max(float((got_f[k].cpu() - want_f[k]).abs().max())
                           for k in want_f)
            ref_mag = max(float(want[k].abs().max()) for k in want)
            finite = all(bool(torch.isfinite(v).all())
                         for o in (got, got_f) for v in o.values())
            shapes_ok = all(tuple(got[k].shape) == tuple(want[k].shape)
                            for k in want)
            counts = {p: per_model[name, b, p] for p in ("exact", "fast")}
            ok = (err_exact <= EXACT_ATOL and err_fast <= FAST_ATOL and finite
                  and shapes_ok
                  and all(c[k] == c["expected"][k] for c in counts.values()
                          for k in KERNELS))
            if not ok:
                failures.append([name, b])
            sel = exes[name, "cuda", "exact"].cost_summary().get(
                "kernel_selection", {}).get(b, [])
            emit({"phase": "main", "model": name, "batch": b,
                  "out_shape": {k: list(v.shape) for k, v in got.items()},
                  "max_abs_err_exact_vs_interpret": err_exact,
                  "max_abs_err_fast_vs_cpu": err_fast,
                  "max_abs_ref": ref_mag, "finite": finite,
                  "launches": counts, "ok": ok,
                  "kernel_selection": [[c["node"], c["kernel"], c["reason"]]
                                       for c in sel]})
    # The wrappers counted the preparing calls alone: the replays pass
    # through none.
    want_wrappers = {k: PREPARE_CALLS * v for k, v in expect_total.items()}
    emit({"phase": "main", "launches": launches, "expected": expect_total,
          "wrapper_launches": wrappers, "wrapper_launches_preparing":
          prepared, "wrapper_expected": want_wrappers,
          "failures": failures})
    problems = []
    if (failures or launches != expect_total
            or not (expect_total["fused_matmul"] and expect_total["fast_act"])
            or wrappers != prepared or wrappers != want_wrappers):
        problems.append(f"main path failed: {failures}, launches {launches}, "
                        f"expected {expect_total}, wrappers {wrappers}, "
                        f"expected {want_wrappers}")
    return exes, inputs, launches, per_model, problems


def phase_path_a(torch, np, exes, inputs):
    """Path A: ``precision="int8"`` and ``"bf16"`` compiled for ``cuda`` and
    ``jit`` on the card.  cuDNN runs deterministic algorithms here, so
    the convolutions before each dense node give the same bits on both
    targets and the int8 outputs can be held bit-equal."""
    import repro_torch
    from repro_torch.table1_models import SUITE

    modes = {"int8": INT8_MODELS, "bf16": tuple(SUITE)}
    for prec, models in modes.items():
        for name in models:
            g = SUITE[name]()
            for target in ("cuda", "jit"):
                exes[name, target, prec] = repro_torch.compile(
                    g, repro_torch.CompileOptions(
                        target=target, precision=prec, device=DEVICE,
                        calibrate=4 if prec == "int8" else None))
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # Programs captured under deterministic cuDNN.  The path, every
        # count set to 0 just before and read just after: the cuda
        # programs prepared, then each called once under the profiler.
        for prec, models in modes.items():
            for name in models:
                for b in PREPARE:
                    exes[name, "jit", prec].ensure_compiled(b)
        reset_counts()
        for prec, models in modes.items():
            for name in models:
                for b in PREPARE:
                    exes[name, "cuda", prec].ensure_compiled(b)
        torch.cuda.synchronize()
        prepared = read_counts()
        outs, per = {}, {}
        launches = {k: 0 for k in KERNELS}
        for prec, models in modes.items():
            for name in models:
                for b in BATCHES:
                    exe = exes[name, "cuda", prec]
                    outs[name, b, prec], per[name, b, prec] = profiled_call(
                        lambda: exe(input=inputs[name, b]))
                    for k in KERNELS:
                        launches[k] += per[name, b, prec][k]
        wrappers = read_counts()
        want_total = {k: 0 for k in KERNELS}
        rows, failures = [], []
        for prec, models in modes.items():
            for name in models:
                dense = sum(n.op == "dense" for n in SUITE[name]().nodes)
                want_counts = {k: 0 for k in KERNELS}
                want_counts["fused_matmul_q8" if prec == "int8"
                            else "fused_matmul"] = dense
                for k, v in want_counts.items():
                    want_total[k] += v * len(BATCHES)
                for b in BATCHES:
                    got = outs[name, b, prec]
                    jit = exes[name, "jit", prec](input=inputs[name, b])
                    ref = exes[name, "interpret", "exact"](input=inputs[name, b])
                    err_jit = max(float((got[k] - jit[k]).abs().max())
                                  for k in jit)
                    equal_jit = all(bool(torch.equal(got[k], jit[k]))
                                    for k in jit)
                    per_example = torch.stack([
                        (got[k] - ref[k]).abs().flatten(1).amax(1)
                        for k in ref]).amax(0)
                    err_ref = float(per_example.max())
                    err_median = float(per_example.median())
                    finite = all(bool(torch.isfinite(v).all())
                                 for v in got.values())
                    shapes_ok = all(tuple(got[k].shape) == tuple(ref[k].shape)
                                    for k in ref)
                    ref_mag = max(float(ref[k].abs().max()) for k in ref)
                    budget = QUANT_BUDGET * max(1.0, ref_mag)
                    ok = (finite and shapes_ok and err_median <= budget
                          and (equal_jit if prec == "int8"
                               else err_jit <= BF16_ATOL)
                          and per[name, b, prec] == want_counts)
                    if not ok:
                        failures.append([name, b, prec])
                    quant = exes[name, "cuda", prec].cost_summary().get("quant")
                    rows.append(dict(
                        phase="main", path="A", model=name, batch=b,
                        precision=prec, bit_equal_cuda_vs_jit=equal_jit,
                        max_abs_err_cuda_vs_jit=err_jit,
                        max_abs_err_vs_interpret_exact=err_ref,
                        median_example_err_vs_interpret_exact=err_median,
                        examples_over_budget=int((per_example > budget).sum()),
                        max_abs_ref=ref_mag, budget=budget,
                        finite=finite, quant=quant,
                        launches=per[name, b, prec], expected=want_counts,
                        ok=ok))
                    emit(rows[-1])
    finally:
        torch.backends.cudnn.deterministic = prev
    want_wrappers = {k: PREPARE_CALLS * v for k, v in want_total.items()}
    emit({"phase": "main", "path": "A", "launches": launches,
          "expected": want_total, "wrapper_launches": wrappers,
          "wrapper_launches_preparing": prepared,
          "wrapper_expected": want_wrappers,
          "cudnn_deterministic": True, "failures": failures})
    problems = []
    if (failures or launches != want_total
            or not (launches["fused_matmul"] and launches["fused_matmul_q8"])
            or wrappers != prepared or wrappers != want_wrappers):
        problems.append(f"path A failed: {failures}, launches {launches}, "
                        f"wrappers {wrappers}")
    return launches, problems


def decode_graph(repro_torch):
    """One decode_attention node at qwen2.5-14b's attention widths, its
    per-example lengths a graph input."""
    mb = repro_torch.ModelBuilder()
    q = mb.input((DECODE["h"], DECODE["d"]), name="q")
    k = mb.input((DECODE["s"], DECODE["hkv"], DECODE["d"]), name="k")
    v = mb.input((DECODE["s"], DECODE["hkv"], DECODE["d"]), name="v")
    lengths = mb.input((), name="lengths", dtype="int32")
    return mb.build([mb.decode_attention(q, k, v, lengths)])


def phase_path_b(torch, np):
    """Path B: the decode graph on ``cuda`` at batch 1 and 8, exact
    against ``interpret`` on the card, fast against the same compile on
    the CPU (batch 1); exactly one decode_attention launch per call."""
    import repro_torch

    g = decode_graph(repro_torch)
    opts = repro_torch.CompileOptions
    exes = {(t, p): repro_torch.compile(g, opts(target=t, precision=p,
                                                device=DEVICE))
            for t, p in (("cuda", "exact"), ("cuda", "fast"),
                         ("interpret", "exact"))}
    exes["cpu", "fast"] = repro_torch.compile(
        g, opts(target="cuda", precision="fast", device="cpu"))
    feeds = {}
    for b, lengths in DECODE_LENGTHS.items():
        q, k, v, lens = decode_inputs(torch, b, DECODE["h"], DECODE["hkv"],
                                      DECODE["d"], DECODE["s"], lengths, 30 + b)
        feeds[b] = {"q": q, "k": k, "v": v, "lengths": lens}
    # K and V are written once into each captured program's static inputs
    # (2.15 GB at batch 8), and every call passes those tensors: a call
    # copies only q and the lengths.
    reset_counts()
    cuda_feeds = {}
    for prec in ("exact", "fast"):
        for b in sorted(DECODE_LENGTHS, reverse=True):     # largest first
            bufs = exes["cuda", prec].input_buffers(b)
            for n in ("k", "v"):
                bufs[n].copy_(feeds[b][n])
            cuda_feeds[prec, b] = dict(feeds[b], k=bufs["k"], v=bufs["v"])
    torch.cuda.synchronize()

    # The path: every count set to 0 before the programs were prepared
    # (above, to hand out their static inputs), read just after; each
    # program called once under the profiler.
    outs, per = {}, {}
    launches = {k: 0 for k in KERNELS}
    for b in DECODE_LENGTHS:
        for prec in ("exact", "fast"):
            exe = exes["cuda", prec]
            outs[b, prec], per[b, prec] = profiled_call(
                lambda: exe(**cuda_feeds[prec, b]))
            for k in KERNELS:
                launches[k] += per[b, prec][k]
    wrappers = read_counts()

    want_counts = {k: int(k == "decode_attention") for k in KERNELS}
    failures = []
    for b in DECODE_LENGTHS:
        (key,) = outs[b, "exact"]
        got, got_f = outs[b, "exact"][key], outs[b, "fast"][key]
        want = exes["interpret", "exact"](**feeds[b])[key]
        err_exact = float((got - want).abs().max())
        err_fast = None
        if b == 1:
            cpu = {n: t.cpu() for n, t in feeds[b].items()}
            err_fast = float((got_f.cpu()
                              - exes["cpu", "fast"](**cpu)[key]).abs().max())
        finite = bool(torch.isfinite(got).all() and torch.isfinite(got_f).all())
        ok = (finite and tuple(got.shape) == (b, DECODE["h"], DECODE["d"])
              and err_exact <= DECODE_ATOL
              and (err_fast is None or err_fast <= DECODE_ATOL)
              and all(per[b, p] == want_counts for p in ("exact", "fast")))
        if not ok:
            failures.append([b, err_exact, err_fast])
        emit({"phase": "main", "path": "B", "batch": b, "shape": DECODE,
              "lengths": DECODE_LENGTHS[b], "out_shape": list(got.shape),
              "max_abs_err_exact_vs_interpret": err_exact,
              "max_abs_err_fast_vs_cpu": err_fast, "atol": DECODE_ATOL,
              "max_abs_ref": float(want.abs().max()), "finite": finite,
              "launches": {p: per[b, p] for p in ("exact", "fast")},
              "kernel_selection": exes["cuda", "exact"].cost_summary()
              ["kernel_selection"][b][0]["reason"], "ok": ok})
    calls = len(DECODE_LENGTHS) * 2
    want_total = {k: calls * v for k, v in want_counts.items()}
    want_wrappers = {k: PREPARE_CALLS * v for k, v in want_total.items()}
    emit({"phase": "main", "path": "B", "launches": launches,
          "expected": want_total, "wrapper_launches": wrappers,
          "wrapper_expected": want_wrappers, "failures": failures})
    problems = []
    if (failures or launches != want_total
            or not launches["decode_attention"]
            or wrappers != want_wrappers):
        problems.append(f"path B failed: {failures}, launches {launches}, "
                        f"wrappers {wrappers}")
    return exes, feeds, cuda_feeds, launches, problems


def program_cases(torch, np, exes, inputs, dec_exes, cuda_feeds):
    """Every captured program of paths 1, A and B: (label, executable,
    two feeds, the launches one replay must make, cuDNN deterministic
    as when it was captured)."""
    from repro_torch.table1_models import SUITE
    rng = np.random.default_rng(99)
    cases = []
    for name in SUITE:
        n_fm, n_fa = expected_launches(SUITE[name]())
        for b in BATCHES:
            x1 = inputs[name, b]
            x2 = rng.standard_normal(x1.shape).astype(np.float32)
            feeds = ({"input": x1}, {"input": x2})
            for target, prec in (("cuda", "exact"), ("cuda", "fast"),
                                 ("jit", "exact"), ("cuda", "int8"),
                                 ("jit", "int8"), ("cuda", "bf16"),
                                 ("jit", "bf16")):
                exe = exes.get((name, target, prec))
                if exe is None:
                    continue
                want = {k: 0 for k in KERNELS}
                if target == "cuda":
                    want["fused_matmul_q8" if prec == "int8"
                         else "fused_matmul"] = n_fm
                    want["fast_act"] = n_fa if prec == "fast" else 0
                path = "1" if prec in ("exact", "fast") else "A"
                cases.append((f"{path} {name} {target} {prec} b{b}", exe,
                              feeds, want, path == "A"))
    for (prec, b), feeds in cuda_feeds.items():
        gen = torch.Generator(device=DEVICE).manual_seed(77 + b)
        other = dict(feeds, q=torch.randn(feeds["q"].shape, generator=gen,
                                          device=DEVICE),
                     lengths=torch.clamp(feeds["lengths"] - 257, min=1))
        want = {k: int(k == "decode_attention") for k in KERNELS}
        cases.append((f"B decode cuda {prec} b{b}", dec_exes["cuda", prec],
                      (feeds, other), want, False))
    return cases


def phase_program(torch, np, cases):
    """Each captured program against the eager program it was captured
    from: two calls on different inputs, each bit-equal to the eager
    walk on its input, the first call's outputs unchanged after the
    second, one replay's launches from the profiler; capture time and
    pool bytes."""
    failures, pool_total, capture_total = [], 0, 0.0
    prev = torch.backends.cudnn.deterministic
    try:
        for label, exe, (f1, f2), want, deterministic in cases:
            torch.backends.cudnn.deterministic = deterministic
            out1 = exe(**f1)
            keep = {k: v.clone() for k, v in out1.items()}
            out2 = exe(**f2)
            eq1 = outputs_equal(out1, eager_call(exe, f1))
            eq2 = outputs_equal(out2, eager_call(exe, f2))
            fresh = outputs_equal(out1, keep)
            differ = not outputs_equal(out1, out2)
            _, prof = profiled_call(lambda: exe(**f1))
            batch = next(iter(out1.values())).shape[0]
            info = exe.cost_summary()["programs"][batch]
            pool_bytes = exe.ensure_compiled(batch).pool_bytes
            ok = (info["captured"] and eq1 and eq2 and fresh and differ
                  and prof == want)
            if not ok:
                failures.append(label)
            pool_total += pool_bytes
            capture_total += info.get("capture_ms", 0.0)
            emit({"phase": "program", "program": label,
                  "bit_equal_to_eager": [eq1, eq2],
                  "first_outputs_unchanged": fresh,
                  "inputs_differ_outputs_differ": differ,
                  "replay_launches_profiler": prof, "expected": want,
                  "capture_ms": info.get("capture_ms"),
                  "pool_bytes_added": pool_bytes,
                  "cudnn_deterministic": deterministic, "ok": ok})
    finally:
        torch.backends.cudnn.deterministic = prev
    emit({"phase": "program", "programs": len(cases),
          "pool_bytes_added_total": pool_total,
          "capture_ms_total": capture_total,
          "failures": failures})
    return [f"program phase failed: {failures}"] if failures else []


def phase_split_counters(torch, np):
    """B1 and B2 reduce K splits through per-tile counters.  A program
    captured with a small plan must replay bit-equal after a program
    with a larger plan was captured, after its own counter buffer grew
    (the outgrown buffer stays held), and after the freed memory of the
    card was handed out and scribbled over."""
    import repro_torch

    def one_dense(k, n, seed):
        mb = repro_torch.ModelBuilder().seed(seed)
        x = mb.input((k,))
        return mb.build([mb.dense(x, n, activation="relu")])

    rows = []
    for prec in ("exact", "int8"):
        small = repro_torch.compile(one_dense(2048, 96, 1), target="cuda",
                                    precision=prec, device=DEVICE)
        large = repro_torch.compile(one_dense(2048, 128, 2), target="cuda",
                                    precision=prec, device=DEVICE)
        x = np.random.default_rng(3).standard_normal((1, 2048)).astype(
            np.float32)
        xl = np.random.default_rng(4).standard_normal((256, 2048)).astype(
            np.float32)
        prog = small.ensure_compiled(1)
        first = small(input=x)
        large.ensure_compiled(256)
        large(input=xl)
        grown = getattr(prog, "eager", prog).ctx.counters.get(
            torch.device(DEVICE), 1 << 16)
        scribble = torch.full((1 << 28,), -1, dtype=torch.int32, device=DEVICE)
        again = small(input=x)
        eager = eager_call(small, {"input": x})
        del scribble
        sel = [c["reason"] for c in
               small.cost_summary()["kernel_selection"][1] +
               large.cost_summary()["kernel_selection"][256]]
        ok = (outputs_equal(first, again) and outputs_equal(first, eager)
              and grown.numel() == 1 << 16)
        rows.append(ok)
        emit({"phase": "split_counters", "precision": prec,
              "plans": sel, "replay_bit_equal_after": ok,
              "grown_to": grown.numel(), "ok": ok})
    return [] if all(rows) else ["split counter check failed"]


def phase_runtime(torch, np, exes, inputs):
    """Batch buckets on the card: a BucketPolicy (engine cache, a cold
    bucket captured in the background while a warm one serves) and the
    legacy batch_buckets; every output bit-equal to its bucket's program
    on the input padded with zero rows, and within EXACT_ATOL of
    interpret."""
    import repro_torch
    from repro_torch.runtime import BucketPolicy
    from repro_torch.table1_models import SUITE

    rng = np.random.default_rng(7)
    failures = []
    policy = BucketPolicy(batch_buckets=RUNTIME_POLICY)
    for name in RUNTIME_MODELS:
        g = SUITE[name]()
        shape = tuple(g.inputs["input"].shape)
        interp = exes[name, "interpret", "exact"]
        bucketed = repro_torch.compile(g, target="cuda", device=DEVICE,
                                       buckets=policy)
        bucketed.warm_up(block=True)
        legacy = repro_torch.compile(g, target="cuda", device=DEVICE,
                                     batch_buckets=LEGACY_BUCKETS)
        for kind, exe, inner, buckets in (
                ("buckets", bucketed, bucketed.inner, RUNTIME_POLICY),
                ("batch_buckets", legacy, legacy, LEGACY_BUCKETS)):
            for batch in RUNTIME_BATCHES:
                x = rng.standard_normal((batch,) + shape).astype(np.float32)
                got = exe(input=x)
                bucket = next((b for b in buckets if b >= batch), batch)
                padded = np.zeros((bucket,) + shape, np.float32)
                padded[:batch] = x
                want = inner(input=padded)
                equal = outputs_equal(got, {k: v[:batch]
                                            for k, v in want.items()})
                ref = interp(input=x)
                err = max(float((got[k] - ref[k]).abs().max()) for k in ref)
                ok = equal and err <= EXACT_ATOL
                if not ok:
                    failures.append([name, kind, batch])
                emit({"phase": "runtime", "model": name, "kind": kind,
                      "batch": batch, "bucket": bucket,
                      "bit_equal_to_padded_bucket_program": equal,
                      "max_abs_err_vs_interpret": err, "ok": ok})
        emit({"phase": "runtime", "model": name, "kind": "buckets",
              "counters": bucketed.runtime_stats()})
        bucketed.shutdown()

    # worker="thread": only the largest bucket warm; calls of batch 3 are
    # served on it while their own bucket is captured in the background.
    g = SUITE["C-HTWK"]()
    exe = repro_torch.compile(g, target="cuda", device=DEVICE,
                              buckets=policy)
    exe.ensure_compiled(RUNTIME_POLICY[-1])
    cold = str(policy.bucket_for(3))
    x = rng.standard_normal((3,) + tuple(g.inputs["input"].shape)).astype(
        np.float32)
    ref = exes["C-HTWK", "interpret", "exact"](input=x)
    # No synchronise while the capture is under way: a device-wide one is
    # refused then, and the outputs are read after it (core/program.py).
    served = []
    t0 = time.perf_counter()
    while cold not in exe.runtime_stats()["warm_buckets"] \
            and len(served) < 2000:
        served.append(exe(input=x))
        time.sleep(0.001)
    warm = exe.wait_warm(timeout=120.0)
    served.append(exe(input=x))
    errs = [max(float((got[k] - ref[k]).abs().max()) for k in ref)
            for got in served]
    stats = exe.runtime_stats()
    ok = (warm and stats["fallback_serves"] >= 1 and stats["bucket_hits"] >= 1
          and stats["compile_stalls"] == 0 and max(errs) <= EXACT_ATOL)
    if not ok:
        failures.append(["thread worker", stats])
    emit({"phase": "runtime", "model": "C-HTWK", "kind": "thread worker",
          "calls_served_while_capturing": len(served) - 1,
          "seconds_to_warm": time.perf_counter() - t0,
          "max_abs_err_vs_interpret": max(errs), "counters": stats,
          "ok": ok})
    exe.shutdown()
    return [f"runtime phase failed: {failures}"] if failures else []


CACHE_SCRIPT = """
import json, sys
sys.path.insert(0, {src!r})
import numpy as np, torch
import repro_torch
from repro_torch.api import targets
from repro_torch.table1_models import SUITE
torch.backends.cudnn.deterministic = True
ran = []
real = targets.run_pipeline
def counted(*a, **kw):
    ran.append(1)
    return real(*a, **kw)
targets.run_pipeline = counted
data = np.load({inputs!r})
report, outs = {{}}, {{}}
for name, prec in {compiles!r}:
    exe = repro_torch.compile(SUITE[name](), target="cuda", precision=prec,
                              device={device!r}, cache_dir={cache!r})
    for b in {batches!r}:
        out = exe(input=data[f"{{name}} {{b}}"])
        for k, v in out.items():
            outs[f"{{name}} {{prec}} {{b}} {{k}}"] = v.cpu().numpy()
    report[f"{{name}} {{prec}}"] = exe.cache_info()
np.savez({outputs!r}, **outs)
print(json.dumps({{"pipelines": len(ran), "cache": report}}))
"""


def phase_cache(torch, np, exes, inputs):
    """serialize/deserialize on the card, and a second process with the
    first one's cache directory (cuDNN deterministic in both)."""
    import shutil
    import repro_torch
    from repro_torch.table1_models import SUITE

    failures = []
    work = os.path.join(ROOT, "build", "chip_smoke_cache")
    shutil.rmtree(work, ignore_errors=True)
    cache_dir = os.path.join(work, "entries")
    os.makedirs(cache_dir)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        outs, feeds = {}, {}
        for name, prec in CACHE_COMPILES:
            exe = repro_torch.compile(SUITE[name](), target="cuda",
                                      precision=prec, device=DEVICE,
                                      cache_dir=cache_dir)
            again = repro_torch.deserialize(exe.serialize())
            for b in BATCHES:
                x = inputs[name, b]
                feeds[f"{name} {b}"] = x
                out = exe(input=x)
                equal = outputs_equal(out, again(input=x))
                for k, v in out.items():
                    outs[f"{name} {prec} {b} {k}"] = v.cpu().numpy()
                if not equal:
                    failures.append(["deserialize", name, prec, b])
                emit({"phase": "cache", "model": name, "precision": prec,
                      "batch": b, "deserialized_bit_equal": equal})
            if exe.cache_info()["programs"] != {b: "miss" for b in BATCHES}:
                failures.append(["first process", exe.cache_info()])
        in_path = os.path.join(work, "inputs.npz")
        out_path = os.path.join(work, "second.npz")
        np.savez(in_path, **feeds)
        script = CACHE_SCRIPT.format(
            src=os.path.join(ROOT, "src"), inputs=in_path, outputs=out_path,
            compiles=list(CACHE_COMPILES), cache=cache_dir,
            batches=list(BATCHES), device=DEVICE)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", script],
                              capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
        if proc.returncode:
            raise SystemExit(f"second process failed:\n{proc.stderr[-3000:]}")
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        second = np.load(out_path)
        equal = (sorted(second.files) == sorted(outs)
                 and all(np.array_equal(second[k], outs[k]) for k in outs))
        hits = all(info["graph"] == "hit"
                   and info["programs"] == {str(b): "hit" for b in BATCHES}
                   for info in report["cache"].values())
        ok = equal and hits and report["pipelines"] == 0
        if not ok:
            failures.append(["second process", report])
        emit({"phase": "cache", "second_process": report,
              "outputs_bit_equal_to_first": equal, "seconds": seconds,
              "ok": ok})
    finally:
        torch.backends.cudnn.deterministic = prev
        shutil.rmtree(work, ignore_errors=True)
    return [f"cache phase failed: {failures}"] if failures else []


# ---------------------------------------------------------------------------
# Slice 6: the executable's one graph pool, the autotuner, mixed precision
# ---------------------------------------------------------------------------
#: The pool phase: VGG19 exact at 8 batch sizes between 129 and 256,
#: arriving in three orders (the largest first, ascending, shuffled);
#: the bound's slack.
POOL_BATCHES = (256, 129, 200, 150, 241, 176, 137, 222)
POOL_ORDERS = (("largest first", POOL_BATCHES),
               ("ascending", tuple(sorted(POOL_BATCHES))),
               ("shuffled", (150, 222, 129, 256, 176, 137, 241, 200)))
POOL_SLACK = 0.10
#: What the 76 programs of paths 1, A and B took when each held a private
#: pool (PERF.md §6, the captured programs' first measurement).
PRIVATE_POOLS_BYTES = 6.98e9


def _reserved(torch) -> int:
    """memory_reserved with the allocator's free cache returned."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def phase_pool(torch, np, all_exes):
    """One graph pool per executable: VGG19 exact at POOL_BATCHES, no
    buckets, the batches arriving in each of POOL_ORDERS.  In every
    order the growth of memory_reserved over the 8 calls stays within
    the batch-256 program's pool plus the 8 programs' static inputs and
    outputs, plus POOL_SLACK (a batch larger than every captured one
    lays the pool out again, largest first); beside it the sum 8 private
    pools take (each program captured again alone, as before the pool
    was shared).  Then replays in reverse and in shuffled order, each
    bit-equal to its eager walk and to the program's first answer,
    which calls to the others and the pool's relayouts left unchanged.
    Last, the pool bytes of every executable of paths 1, A and B."""
    import random
    import repro_torch
    from repro_torch.core.program import CapturedProgram
    from repro_torch.table1_models import SUITE

    g = SUITE["VGG19"]()
    rng = np.random.default_rng(5)
    feeds = {b: rng.standard_normal((b,) + tuple(g.inputs["input"].shape))
             .astype(np.float32) for b in POOL_BATCHES}
    failures, private = [], None
    for order, batches in POOL_ORDERS:
        exe = repro_torch.compile(g, target="cuda", device=DEVICE)
        before = _reserved(torch)
        t0 = time.perf_counter()
        first = {b: exe(input=feeds[b]) for b in batches}
        torch.cuda.synchronize()
        calls_s = time.perf_counter() - t0
        growth = _reserved(torch) - before
        progs = {b: exe.ensure_compiled(b) for b in batches}
        statics = sum(t.numel() * t.element_size() for p in progs.values()
                      for t in list(p.static_inputs.values())
                      + list(p.static_outputs.values()))
        pool = exe.cost_summary()["graph_pool_bytes"]
        bound = (progs[256].pool_bytes + statics) * (1 + POOL_SLACK)
        if private is None:
            # What private pools take: each program captured again
            # alone, from its own eager walk.
            private = 0
            specs = {n: (tuple(s.shape), torch.float32)
                     for n, s in exe.graph.inputs.items()}
            for b in batches:
                alone = CapturedProgram(progs[b].eager, specs,
                                        torch.device(DEVICE))
                private += alone.pool_bytes
                alone.release()
                del alone
            _reserved(torch)
        replays_ok = True
        shuffled = list(batches)
        random.Random(7).shuffle(shuffled)
        for b in list(reversed(batches)) + shuffled:
            out = exe(input=feeds[b])
            replays_ok &= outputs_equal(out, eager_call(
                exe, {"input": feeds[b]}))
            replays_ok &= outputs_equal(out, first[b])
        ok = replays_ok and growth <= bound
        if not ok:
            failures.append([order, growth, bound, replays_ok])
        emit({"phase": "pool", "model": "VGG19", "precision": "exact",
              "order_name": order, "order": list(batches),
              "reserved_growth_bytes": growth, "graph_pool_bytes": pool,
              "batch256_pool_bytes": progs[256].pool_bytes,
              "static_in_out_bytes": statics, "bound_bytes": bound,
              "private_pools_bytes": private, "calls_s": calls_s,
              "replays_bit_equal_any_order": replays_ok, "ok": ok})
        del exe, progs, first
        _reserved(torch)
    seen, total, programs = set(), 0, 0
    for exe in all_exes:
        if id(exe) in seen or not hasattr(exe, "_programs"):
            continue
        seen.add(id(exe))
        total += exe.cost_summary().get("graph_pool_bytes", 0)
        programs += sum(isinstance(p, CapturedProgram)
                        for p in exe._programs.values())
    emit({"phase": "pool", "paths": "1, A, B",
          "captured_programs": programs, "graph_pool_bytes_total": total,
          "private_pools_bytes_before": PRIVATE_POOLS_BYTES})
    return [f"pool phase failed: {failures}"] if failures else []


#: The autotune phase: models and precisions tuned with autotune="full"
#: at BATCHES, path B's decode node at batch 8, and the budget of each
#: compile (measurement ends well inside the script's time limit).
TUNE_COMPILES = (("C-HTWK", "exact"), ("C-HTWK", "int8"),
                 ("VGG19", "exact"), ("VGG19", "int8"))
TUNE_BUDGET_MS = 60_000.0
TUNE_DECODE_BATCH = 8

TUNE_SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {src!r})
import numpy as np, torch
import chip_smoke as cs
import repro_torch
from repro_torch.table1_models import SUITE
torch.backends.cudnn.deterministic = True
data = np.load({inputs!r})
report, outs = {{}}, {{}}
for name, prec in {compiles!r}:
    exe = repro_torch.compile(SUITE[name](), target="cuda", precision=prec,
                              device={device!r}, autotune="cached",
                              cache_dir={cache!r})
    for b in {batches!r}:
        out = exe(input=data[f"{{name}} {{b}}"])
        for k, v in out.items():
            outs[f"{{name}} {{prec}} {{b}} {{k}}"] = v.cpu().numpy()
        report[f"{{name}} {{prec}} {{b}}"] = (
            exe.cost_summary()["autotune"][b]["measured_nodes"])
    report[f"{{name}} {{prec}} decisions"] = [
        r["source"] for r in exe.cost_summary()["graph_decisions"]["sites"]
        if r["source"] == "measured"]
cs.DEVICE = {device!r}
cs.DECODE = {decode!r}
cs.DECODE_LENGTHS = {lengths!r}
exe = repro_torch.compile(cs.decode_graph(repro_torch), target="cuda",
                          device={device!r}, autotune="cached",
                          cache_dir={cache!r})
b = {dbatch!r}
q, k, v, lens = cs.decode_inputs(torch, b, cs.DECODE["h"], cs.DECODE["hkv"],
                                 cs.DECODE["d"], cs.DECODE["s"],
                                 cs.DECODE_LENGTHS[b], 40)
out = exe(q=q, k=k, v=v, lengths=lens)
for key, val in out.items():
    outs[f"decode {{b}} {{key}}"] = val.cpu().numpy()
report[f"decode {{b}}"] = exe.cost_summary()["autotune"][b]["measured_nodes"]
np.savez({outputs!r}, **outs)
print(json.dumps(report))
"""


def grid_checks(torch, np):
    """Every grid point of the tuned kernels against its plain version at
    the main path's shapes, under the check phase's bounds: B1 (f32 and
    bf16, both layouts, no epilogue and relu + affine) within MATMUL_ATOL
    (x sqrt(K/256) above K=256); B2 (both layouts) bit-equal for
    none/relu/leaky_relu/affine; B4 (path B at batch 1 and 8, exact and
    fast) within DECODE_ATOL of its tiled form."""
    from repro_torch.kernels import qmath
    from repro_torch.kernels.decode_attention import ref as attn_ref
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.fused_matmul import ref as fm_ref
    from repro_torch.kernels.fused_matmul.ops import fused_matmul, fused_matmul_q8
    from repro_torch.autotune.tactics import enumerate_tactics

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(13)
    rows, failures = {}, []
    epis = [e for e in EPILOGUES if e[0] in Q8_BIT_EQUAL]
    for k, n in MAIN_DENSE_KN:
        for m in BATCHES:
            atol = MATMUL_ATOL * max(1.0, (k / 256) ** 0.5)
            x_np = rng.standard_normal((m, k)).astype(np.float32)
            w_np = rng.standard_normal((k, n)).astype(np.float32)
            x = torch.from_numpy(x_np).to(dev)
            vec = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
            bias, scale = vec(rng.standard_normal(n)), vec(rng.uniform(0.5, 1.5, n))
            offset = vec(rng.standard_normal(n))
            xs = qmath.tensor_scale(float(np.abs(x_np).max()) * 0.8)
            xq = qmath.quantize_q8(x, xs)
            for layout in ("io", "oi"):
                w = torch.from_numpy(w_np if layout == "io" else
                                     np.ascontiguousarray(w_np.T)).to(dev)
                shape = dict(m=m, k=k, n=n, w_layout=layout)
                for dtype in (torch.float32, torch.bfloat16):
                    xd, wd = x.to(dtype), w.to(dtype)
                    grid = enumerate_tactics("cuda.fused_matmul",
                                             itemsize=xd.element_size(),
                                             **shape)
                    for block, p in grid:
                        for name, fn, fast, attrs, affine in EPILOGUES[:2] + EPILOGUES[-1:]:
                            s, o = (scale, offset) if affine else (None, None)
                            got = fused_matmul(xd, wd, bias, s, o, fn=fn,
                                               w_layout=layout, plan=p)
                            want = fm_ref.fused_matmul_ref(
                                xd.float(), wd.float(), bias, s, o, fn=fn,
                                w_layout=layout)
                            err = float((got - want).abs().max())
                            key = "fused_matmul"
                            rows.setdefault(key, [0, 0.0])
                            rows[key][0] += 1
                            rows[key][1] = max(rows[key][1], err)
                            if err > atol:
                                failures.append([key, m, k, n, layout,
                                                 str(dtype), block, name, err])
                wq, deq = qmath.quantize_weight(
                    w, xs, qmath.channel_scales(w_np, 1), layout)
                for block, p in enumerate_tactics("cuda.fused_matmul_q8",
                                                  **shape):
                    for name, fn, fast, attrs, affine in epis:
                        s, o = (scale, offset) if affine else (None, None)
                        kw = dict(fn=fn, fast=fast, w_layout=layout,
                                  attrs=attrs)
                        got = fused_matmul_q8(x, wq, deq, bias, s, o,
                                              x_scale=xs, plan=p, **kw)
                        want = fm_ref.fused_matmul_q8_ref(xq, wq, deq, bias,
                                                          s, o, **kw)
                        equal = bool(torch.equal(got, want))
                        key = "fused_matmul_q8"
                        rows.setdefault(key, [0, 0.0])
                        rows[key][0] += 1
                        rows[key][1] = max(rows[key][1],
                                           float((got - want).abs().max()))
                        if not equal:
                            failures.append([key, m, k, n, layout, block,
                                             name])
    for b in (1, TUNE_DECODE_BATCH):
        q, k, v, lens = decode_inputs(torch, b, DECODE["h"], DECODE["hkv"],
                                      DECODE["d"], DECODE["s"],
                                      DECODE_LENGTHS[b], 50 + b)
        for fast in (False, True):
            want = attn_ref.decode_attention_tiled(q, k, v, lens, fast=fast)
            for block, (tpc, chunks) in enumerate_tactics(
                    "cuda.decode_attention", b=b, hkv=DECODE["hkv"],
                    s=DECODE["s"]):
                got = decode_attention(q, k, v, lens, fast=fast,
                                       tiles_per_chunk=tpc)
                err = float((got - want).abs().max())
                rows.setdefault("decode_attention", [0, 0.0])
                rows["decode_attention"][0] += 1
                rows["decode_attention"][1] = max(
                    rows["decode_attention"][1], err)
                if err > DECODE_ATOL:
                    failures.append(["decode_attention", b, fast, block, err])
        del q, k, v
    torch.cuda.synchronize()
    emit({"phase": "autotune", "grid_checks": {
        k: {"cases": c, "max_abs_err": e} for k, (c, e) in rows.items()},
        "bounds": {"fused_matmul": "MATMUL_ATOL * sqrt(K / 256) for K > 256",
                   "fused_matmul_q8": f"bit-equal for {list(Q8_BIT_EQUAL)}",
                   "decode_attention": DECODE_ATOL},
        "failures": failures[:20]})
    return failures


def _tune_rows(exe, batch):
    """Each tuned node's candidates (device µs) and winner, and each graph
    decision site's."""
    sel = exe.cost_summary()["kernel_selection"][batch]
    nodes = [{"node": c["node"], "kernel": c["kernel"], "source": c["source"],
              "winner": c["tactic"] or "heuristic", "block": c["block"],
              "measured_us": c["measured_us"]}
             for c in sel]
    return nodes


def phase_autotune(torch, np, exes, inputs):
    """autotune="full" on the card: the grid checks, then C-HTWK and VGG19
    at exact and int8 (batch 1 and 256) and path B's decode node (batch
    8), each tuned program held against interpret within its path's
    bound and bit-equal to its eager walk; tuned against heuristic time;
    then a second process with autotune="cached" on the same cache
    directory measures nothing and matches bit for bit."""
    import shutil
    import repro_torch
    from repro_torch.table1_models import SUITE

    problems = []
    if grid_checks(torch, np):
        problems.append("autotune grid checks failed")
    work = os.path.join(ROOT, "build", "chip_smoke_tune")
    shutil.rmtree(work, ignore_errors=True)
    cache_dir = os.path.join(work, "entries")
    os.makedirs(cache_dir)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    failures, outs, feeds = [], {}, {}
    try:
        t_all = time.perf_counter()
        for name, prec in TUNE_COMPILES:
            t0 = time.perf_counter()
            exe = repro_torch.compile(
                SUITE[name](), target="cuda", precision=prec, device=DEVICE,
                autotune="full", autotune_budget_ms=TUNE_BUDGET_MS,
                cache_dir=cache_dir, calibrate=4 if prec == "int8" else None)
            for b in PREPARE:
                exe.ensure_compiled(b)
            tune_s = time.perf_counter() - t0
            heur = exes[name, "cuda", prec]
            decisions = exe.cost_summary()["graph_decisions"]
            for b in BATCHES:
                x = inputs[name, b]
                feeds[f"{name} {b}"] = x
                got = exe(input=x)
                for k, v in got.items():
                    outs[f"{name} {prec} {b} {k}"] = v.cpu().numpy()
                eager_equal = outputs_equal(got, eager_call(exe, {"input": x}))
                ref = exes[name, "interpret", "exact"](input=x)
                per_example = torch.stack([
                    (got[k] - ref[k]).abs().flatten(1).amax(1)
                    for k in ref]).amax(0)
                err = float(per_example.max())
                ref_mag = max(float(ref[k].abs().max()) for k in ref)
                if prec == "exact":
                    bound = EXACT_ATOL
                    within = err <= bound
                else:
                    bound = QUANT_BUDGET * max(1.0, ref_mag)
                    within = float(per_example.median()) <= bound
                finite = all(bool(torch.isfinite(v).all())
                             for v in got.values())
                xt = torch.as_tensor(x, device=DEVICE)
                times = {}
                for tag, e in (("tuned", exe), ("heuristic", heur)):
                    times[f"{tag}_ms"] = host_median_ms(lambda: e(input=xt))
                    times[f"{tag}_device_ms"] = device_ms(lambda: e(input=xt))
                rep = exe.cost_summary()["autotune"][b]
                ok = eager_equal and within and finite
                if not ok:
                    failures.append([name, prec, b, err, eager_equal])
                emit({"phase": "autotune", "model": name, "precision": prec,
                      "batch": b, "nodes": _tune_rows(exe, b),
                      "measured_nodes": rep["measured_nodes"],
                      "cached_nodes": rep["cached_nodes"],
                      "spent_ms": rep["spent_ms"],
                      "max_abs_err_vs_interpret_exact": err,
                      "median_example_err": float(per_example.median()),
                      "bound": bound, "bit_equal_to_eager": eager_equal,
                      "finite": finite, **times, "ok": ok})
            emit({"phase": "autotune", "model": name, "precision": prec,
                  "graph_decisions": [
                      {k: r.get(k) for k in ("kind", "node", "winner",
                                             "source", "measured_us")}
                      for r in decisions["sites"]],
                  "pipeline": decisions["pipeline"],
                  "decisions_spent_ms": decisions["spent_ms"],
                  "tuning_s": tune_s})
        # Path B's decode node at batch 8.
        b = TUNE_DECODE_BATCH
        t0 = time.perf_counter()
        dexe = repro_torch.compile(
            decode_graph(repro_torch), target="cuda", device=DEVICE,
            autotune="full", autotune_budget_ms=TUNE_BUDGET_MS,
            cache_dir=cache_dir)
        q, k, v, lens = decode_inputs(torch, b, DECODE["h"], DECODE["hkv"],
                                      DECODE["d"], DECODE["s"],
                                      DECODE_LENGTHS[b], 40)
        bufs = dexe.input_buffers(b)
        bufs["k"].copy_(k)
        bufs["v"].copy_(v)
        tune_s = time.perf_counter() - t0
        dfeeds = {"q": q, "k": bufs["k"], "v": bufs["v"], "lengths": lens}
        got = dexe(**dfeeds)
        for key, val in got.items():
            outs[f"decode {b} {key}"] = val.cpu().numpy()
        eager_equal = outputs_equal(got, eager_call(dexe, dfeeds))
        iexe = repro_torch.compile(decode_graph(repro_torch),
                                   target="interpret", device=DEVICE)
        want = iexe(q=q, k=k, v=v, lengths=lens)
        err = max(float((got[x] - want[x]).abs().max()) for x in want)
        del k, v
        heur = repro_torch.compile(decode_graph(repro_torch), target="cuda",
                                   device=DEVICE)
        hb = heur.input_buffers(b)
        hb["k"].copy_(bufs["k"])
        hb["v"].copy_(bufs["v"])
        hfeeds = dict(dfeeds, k=hb["k"], v=hb["v"])
        times = {"tuned_ms": host_median_ms(lambda: dexe(**dfeeds)),
                 "tuned_device_ms": device_ms(lambda: dexe(**dfeeds)),
                 "heuristic_ms": host_median_ms(lambda: heur(**hfeeds)),
                 "heuristic_device_ms": device_ms(lambda: heur(**hfeeds))}
        del heur, hb, hfeeds
        ok = eager_equal and err <= DECODE_ATOL
        if not ok:
            failures.append(["decode", b, err, eager_equal])
        emit({"phase": "autotune", "model": "decode qwen2.5-14b",
              "batch": b, "nodes": _tune_rows(dexe, b),
              "measured_nodes": dexe.cost_summary()["autotune"][b]
              ["measured_nodes"], "max_abs_err_vs_interpret_exact": err,
              "bound": DECODE_ATOL, "bit_equal_to_eager": eager_equal,
              "tuning_s": tune_s, **times, "ok": ok})
        del dexe, bufs, dfeeds, iexe
        tuning_total_s = time.perf_counter() - t_all

        # The second process: autotune="cached" on the same directory.
        in_path = os.path.join(work, "inputs.npz")
        out_path = os.path.join(work, "second.npz")
        np.savez(in_path, **feeds)
        script = TUNE_SCRIPT.format(
            root=ROOT, src=os.path.join(ROOT, "src"), inputs=in_path,
            outputs=out_path, compiles=list(TUNE_COMPILES), cache=cache_dir,
            batches=list(BATCHES), dbatch=b, device=DEVICE, decode=DECODE,
            lengths=DECODE_LENGTHS)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", script],
                              capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode:
            raise SystemExit(f"cached process failed:\n{proc.stderr[-3000:]}")
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        second = np.load(out_path)
        equal = (sorted(second.files) == sorted(outs)
                 and all(np.array_equal(second[x], outs[x]) for x in outs))
        measured_nothing = not any(report.values())
        ok = equal and measured_nothing
        if not ok:
            failures.append(["cached process", report, equal])
        emit({"phase": "autotune", "second_process": "autotune=cached",
              "measured": report, "outputs_bit_equal_to_first": equal,
              "seconds": seconds, "tuning_total_s": tuning_total_s,
              "ok": ok})
    finally:
        torch.backends.cudnn.deterministic = prev
        shutil.rmtree(work, ignore_errors=True)
    if failures:
        problems.append(f"autotune phase failed: {failures}")
    return problems


MIXED_MODELS = INT8_MODELS


def phase_mixed(torch, np, exes, inputs):
    """precision="mixed" on the card (C-HTWK, C-BH, VGG19; batch 1 and
    256): each site's measured candidates, errors and winner, every
    winner within its budget, the median example within QUANT_BUDGET x
    max(1, max |out|) of interpret exact.  Then two seeded caches: every
    dense site int8 (conv sites f32) must give the int8 program bit for
    bit, every site f32 (precision_budget=1e-9, measured) the f32
    program."""
    import shutil
    import repro_torch
    from repro_torch.autotune.cache import (TacticCache,
                                            environment_fingerprint,
                                            tactic_key)
    from repro_torch.core.passes import run_pipeline
    from repro_torch.table1_models import SUITE
    quantize = sys.modules["repro_torch.core.passes.quantize"]

    work = os.path.join(ROOT, "build", "chip_smoke_mixed")
    shutil.rmtree(work, ignore_errors=True)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    failures = []
    try:
        for name in MIXED_MODELS:
            g = SUITE[name]()
            t0 = time.perf_counter()
            exe = repro_torch.compile(
                g, target="cuda", precision="mixed", device=DEVICE,
                cache_dir=os.path.join(work, "measured"),
                autotune_budget_ms=TUNE_BUDGET_MS)
            mixed_s = time.perf_counter() - t0
            stats = next(p for p in exe.report["passes"]
                         if p["pass"] == "quantize")["mixed"]
            budget = stats["budget"]
            within = all(s["max_abs_err"].get(s["winner"], 0.0) <= budget
                         for s in stats["sites"].values())
            for b in BATCHES:
                x = inputs[name, b]
                got = exe(input=x)
                ref = exes[name, "interpret", "exact"](input=x)
                per_example = torch.stack([
                    (got[k] - ref[k]).abs().flatten(1).amax(1)
                    for k in ref]).amax(0)
                ref_mag = max(float(ref[k].abs().max()) for k in ref)
                bound = QUANT_BUDGET * max(1.0, ref_mag)
                median = float(per_example.median())
                eager_equal = outputs_equal(got, eager_call(exe, {"input": x}))
                ok = within and median <= bound and eager_equal
                if not ok:
                    failures.append([name, b, median, within, eager_equal])
                emit({"phase": "mixed", "model": name, "batch": b,
                      "sites": stats["sites"], "decisions":
                      exe.graph.quant["decisions"], "budget": budget,
                      "sites_within_budget": within,
                      "median_example_err_vs_interpret_exact": median,
                      "max_abs_err_vs_interpret_exact":
                      float(per_example.max()), "bound": bound,
                      "bit_equal_to_eager": eager_equal,
                      "measure_ms": stats["spent_ms"], "compile_s": mixed_s,
                      "ok": ok})
            # Seeded: every dense site int8 -> the int8 program.
            pre, _ = run_pipeline(g, PRE_QUANTIZE)
            seeded = os.path.join(work, f"seeded {name}")
            fp = environment_fingerprint(DEVICE)
            tc = TacticCache(os.path.join(seeded, "tactics"))
            for node in pre.nodes:
                if node.op in quantize.QUANT_OPS and "kernel" in node.params:
                    desc = quantize.site_desc(
                        node, pre, quantize.DEFAULT_PRECISION_BUDGET,
                        "absmax", DEVICE)
                    tc.store(tactic_key(desc, fp), {
                        "winner": "int8" if node.op == "dense" else "f32",
                        "fingerprint": fp})
            all_int8 = repro_torch.compile(
                g, target="cuda", precision="mixed", device=DEVICE,
                autotune="cached", cache_dir=seeded)
            all_f32 = repro_torch.compile(
                g, target="cuda", precision="mixed", device=DEVICE,
                precision_budget=1e-9, autotune_budget_ms=TUNE_BUDGET_MS,
                cache_dir=os.path.join(work, "tight"))
            f32 = repro_torch.compile(g, target="cuda", precision="f32",
                                      device=DEVICE)
            int8 = exes.get((name, "cuda", "int8"))
            checks = {}
            for b in BATCHES:
                x = inputs[name, b]
                checks[f"all_int8_bit_equal_int8 b{b}"] = outputs_equal(
                    all_int8(input=x), int8(input=x))
                checks[f"all_f32_bit_equal_f32 b{b}"] = outputs_equal(
                    all_f32(input=x), f32(input=x))
            checks["all_int8_decisions"] = all_int8.graph.quant["decisions"]
            checks["all_f32_decisions"] = all_f32.graph.quant["decisions"]
            ok = (all(v for k, v in checks.items() if "bit_equal" in k)
                  and all_f32.graph.quant["decisions"]["f32"]
                  == sum(all_f32.graph.quant["decisions"].values()))
            if not ok:
                failures.append([name, "seeded", checks])
            emit({"phase": "mixed", "model": name, "seeded": checks,
                  "ok": ok})
    finally:
        torch.backends.cudnn.deterministic = prev
        shutil.rmtree(work, ignore_errors=True)
    return [f"mixed phase failed: {failures}"] if failures else []


# ---------------------------------------------------------------------------
# Slice 7: the frontends, capture bundles and python -m repro_torch.replay
# ---------------------------------------------------------------------------
#: The Table-1 models the frontends and replay phases drive (the two with
#: dense nodes at both ends of the suite's size).
FRONTEND_MODELS = ("C-HTWK", "VGG19")
#: The replay phase's bundles: (model, precision), autotune="full".
REPLAY_BUNDLES = (("VGG19", "exact"), ("C-HTWK", "int8"))
REPLAY_TIMEOUT_S = 300


def twin_htwk(p):
    """C-HTWK (``table1_models.htwk_classifier``) written as a plain
    function over ``repro_torch.frontends.ops``, on the builder graph's
    own weight arrays ``p``."""
    from repro_torch.frontends import ops as F

    def htwk(input):
        h = F.conv2d(input, p["conv2d_1/kernel"], p["conv2d_1/bias"],
                     strides=(2, 2), activation="relu")
        h = F.batchnorm(h, p["bn_3/gamma"], p["bn_3/beta"], p["bn_3/mean"],
                        p["bn_3/var"])
        h = F.conv2d(h, p["conv2d_4/kernel"], p["conv2d_4/bias"],
                     strides=(2, 2), activation="relu")
        h = F.dense(F.flatten(h), p["dense_7/kernel"], p["dense_7/bias"],
                    activation="relu")
        return F.softmax(F.dense(h, p["dense_9/kernel"], p["dense_9/bias"]))

    return htwk


def twin_vgg19(p):
    """VGG19 (``table1_models.vgg19_style``) as a plain function over
    ``repro_torch.frontends.ops``, on the builder graph's weights ``p``:
    five blocks of 3x3 convolutions and a max pool, three dense layers,
    a softmax."""
    from repro_torch.frontends import ops as F
    layers = lambda kind: sorted({k.split("/")[0] for k in p
                                  if k.startswith(kind + "_")},
                                 key=lambda n: int(n.split("_")[1]))
    convs, dense = layers("conv2d"), layers("dense")

    def vgg19(input):
        h, conv = input, iter(convs)
        for n_convs in (2, 2, 4, 4, 4):
            for _ in range(n_convs):
                c = next(conv)
                h = F.conv2d(h, p[f"{c}/kernel"], p[f"{c}/bias"],
                             activation="relu")
            h = F.maxpool(h)
        h = F.flatten(h)
        for d in dense[:-1]:
            h = F.dense(h, p[f"{d}/kernel"], p[f"{d}/bias"],
                        activation="relu")
        last = dense[-1]
        return F.softmax(F.dense(h, p[f"{last}/kernel"], p[f"{last}/bias"]))

    return vgg19


TWINS = {"C-HTWK": twin_htwk, "VGG19": twin_vgg19}


def phase_frontends(torch, np, exes, inputs, dec_exes, cuda_feeds):
    """The frontends on the card, at full widths.  C-HTWK and VGG19
    written as functions over ``repro_torch.frontends.ops`` and traced
    (their node and output names differ from the builder graphs', their
    weights are the same arrays), compiled at exact and fast (batch 1 and
    256) and C-HTWK at int8 (batch 256); ``ops.decode_attention`` at path
    B's widths (batch 1); and C-HTWK and VGG19 compiled from an ``.npz``
    path, from a ModelBuilder without ``.build()`` and from a bare
    callable with ``example_inputs=`` on the card (exact, batch 1 and
    256).  Each output bit-equal to the main path's program on the same
    feeds, and each replay's launches (the profiler's, by kernel name)
    equal to that program's.  Every count is set to 0 before these
    programs are prepared and read after their calls."""
    import repro_torch
    from repro_torch.core import TensorSpec
    from repro_torch.frontends import ops as F
    from repro_torch.frontends.container import save_model
    from repro_torch.table1_models import SUITE

    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "chiprun_out", "frontends")
    os.makedirs(out_dir, exist_ok=True)
    cases = []   # (label, exe, main-path exe, batches, deterministic cuDNN)
    for name in FRONTEND_MODELS:
        g = SUITE[name]()
        shape = tuple(g.inputs["input"].shape)
        traced = repro_torch.trace(TWINS[name](g.params), shape)
        for prec in ("exact", "fast"):
            cases.append((f"traced {name} {prec}", repro_torch.compile(
                traced, target="cuda", precision=prec, device=DEVICE),
                exes[name, "cuda", prec], BATCHES, False))
        if name == "C-HTWK":
            cases.append((f"traced {name} int8", repro_torch.compile(
                traced, target="cuda", precision="int8", calibrate=4,
                device=DEVICE), exes[name, "cuda", "int8"], BATCHES[-1:],
                True))
        path = os.path.join(out_dir, f"{name}.npz")
        save_model(g, path)
        mb = repro_torch.ModelBuilder()
        mb.graph = g.copy()
        example = torch.as_tensor(inputs[name, 1], device=DEVICE)
        for how, model, kw in (
                ("container", path, {}),
                ("builder", mb, {"outputs": list(g.outputs)}),
                ("callable", TWINS[name](g.params),
                 {"example_inputs": (example,)})):
            cases.append((f"{how} {name} exact", repro_torch.compile(
                model, target="cuda", device=DEVICE, **kw),
                exes[name, "cuda", "exact"], BATCHES, False))
    dec_graph = repro_torch.trace(
        lambda q, k, v, lengths: F.decode_attention(q, k, v, lengths),
        (DECODE["h"], DECODE["d"]), (DECODE["s"], DECODE["hkv"], DECODE["d"]),
        (DECODE["s"], DECODE["hkv"], DECODE["d"]), TensorSpec((), "int32"))
    dec = repro_torch.compile(dec_graph, target="cuda", device=DEVICE)

    prev = torch.backends.cudnn.deterministic
    failures, rows = [], []
    launches = {k: 0 for k in KERNELS}
    try:
        # The path: counts set to 0, every program prepared (largest batch
        # first; int8 under deterministic cuDNN, as path A's programs
        # were captured), then each called once under the profiler.
        reset_counts()
        for _, exe, _, batches, det in cases:
            torch.backends.cudnn.deterministic = det
            for b in sorted(batches, reverse=True):
                exe.ensure_compiled(b)
        torch.backends.cudnn.deterministic = prev
        dec.ensure_compiled(1)
        torch.cuda.synchronize()
        prepared = read_counts()
        main_counts = {}
        for label, exe, main, batches, det in cases:
            torch.backends.cudnn.deterministic = det
            for b in batches:
                x = torch.as_tensor(inputs[label.split()[1], b],
                                    device=DEVICE)
                got, counts = profiled_call(lambda: exe(input=x))
                key = (id(main), b)
                if key not in main_counts:
                    main_counts[key] = profiled_call(lambda: main(input=x))
                want, want_counts = main_counts[key]
                equal = (len(got) == len(want) == 1 and torch.equal(
                    next(iter(got.values())), next(iter(want.values()))))
                for k in KERNELS:
                    launches[k] += counts[k]
                ok = equal and counts == want_counts and any(counts.values())
                if not ok:
                    failures.append([label, b, {"bit_equal": equal},
                                     counts, want_counts])
                rows.append({"case": label, "batch": b, "bit_equal": equal,
                             "launches": counts, "main_launches": want_counts,
                             "ok": ok})
        torch.backends.cudnn.deterministic = prev
        feeds = cuda_feeds["exact", 1]
        got, counts = profiled_call(lambda: dec(**feeds))
        want = dec_exes["cuda", "exact"](**feeds)
        equal = torch.equal(next(iter(got.values())),
                            next(iter(want.values())))
        for k in KERNELS:
            launches[k] += counts[k]
        want_counts = {k: int(k == "decode_attention") for k in KERNELS}
        ok = equal and counts == want_counts
        if not ok:
            failures.append(["traced decode_attention", 1,
                             {"bit_equal": equal}, counts, want_counts])
        rows.append({"case": "traced decode_attention", "batch": 1,
                     "shape": DECODE, "lengths": DECODE_LENGTHS[1],
                     "bit_equal": equal, "launches": counts,
                     "main_launches": want_counts, "ok": ok})
        wrappers = read_counts()
    finally:
        torch.backends.cudnn.deterministic = prev
    # The wrappers counted the preparing calls alone (a warm-up and a
    # captured call each): twice one replay's launches.
    want_wrappers = {k: 0 for k in KERNELS}
    for row in rows:
        for k in KERNELS:
            want_wrappers[k] += PREPARE_CALLS * row["launches"][k]
    if (wrappers != prepared or wrappers != want_wrappers
            or not all(launches.values())):
        failures.append(["launches", launches, wrappers, want_wrappers])
    seconds = time.perf_counter() - t_phase
    emit({"phase": "frontends", "cases": rows, "launches": launches,
          "wrapper_launches": wrappers, "wrapper_expected": want_wrappers,
          "seconds": seconds, "failures": failures, "ok": not failures})
    return [f"frontends phase failed: {failures}"] if failures else []


def replay_clis(bundles, *extra):
    """``python -m repro_torch.replay <bundle> --json`` of each bundle in
    a fresh process, the processes all started together (a replay resolves every decision from the bundle's tactic
    entries, ``autotune="cached"``, so it times nothing that another
    process on the card could sway): (exit code, its JSON result or None,
    seconds since the start, stderr) for each, in order."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.replay", bundle, "--json",
         *extra], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for bundle in bundles]
    out = []
    for proc in procs:
        try:
            stdout, stderr = proc.communicate(
                timeout=max(1.0, REPLAY_TIMEOUT_S - (time.perf_counter()
                                                     - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        try:
            result = json.loads(stdout)
        except ValueError:
            result = None
        out.append((proc.returncode, result, seconds, stderr[-2000:]))
    return out


def phase_replay(torch, np):
    """Capture bundles on the card: VGG19 exact and C-HTWK int8 compiled
    with ``autotune="full"``, a fresh cache directory and ``capture=``
    into ``chiprun_out/bundles``, at batch 256 then 1; each replayed by
    ``python -m repro_torch.replay --json`` in a fresh process, which
    must exit 0 with no divergence (outputs bit-exact, selections with
    their tactics equal); a copy with one byte of an ``io.npz`` flipped
    must exit 2.  The three replay processes run together, after the
    captures (:func:`replay_clis`).  A decode_attention bundle is left
    out: its seeded inputs cast a standard normal to int32 for
    ``lengths``, as the reference's do, so it would replay lengths of 0
    and below."""
    import shutil
    import repro_torch
    from repro_torch.table1_models import SUITE

    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "chiprun_out", "bundles")
    work = os.path.join(ROOT, "build", "chip_smoke_replay")
    for d in (root, work):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    failures, bundles, rows = [], [], []
    try:
        for name, prec in REPLAY_BUNDLES:
            bundle = os.path.join(root, f"{name}-{prec}")
            t0 = time.perf_counter()
            exe = repro_torch.compile(
                SUITE[name](), target="cuda", precision=prec, device=DEVICE,
                autotune="full", autotune_budget_ms=TUNE_BUDGET_MS,
                cache_dir=os.path.join(work, f"{name}-{prec}"),
                capture=bundle, calibrate=4 if prec == "int8" else None)
            for b in PREPARE:
                exe.ensure_compiled(b)
            compile_s = time.perf_counter() - t0
            files = [os.path.join(r, n) for r, _, ns in os.walk(bundle)
                     for n in ns]
            measured = [n for b in BATCHES for n in
                        exe.cost_summary()["autotune"][b]["measured_nodes"]]
            bundles.append(bundle)
            rows.append({
                "bundle": os.path.relpath(bundle, ROOT), "model": name,
                "precision": prec, "files": len(files),
                "bytes": sum(os.path.getsize(f) for f in files),
                "compile_s": compile_s,
                "record_s_by_batch": exe._capture.seconds,
                "measured_nodes": measured})
        # One byte of the first bundle's io.npz flipped, in a copy: the
        # manifest's hash refuses it (exit 2) before anything runs.
        tampered = os.path.join(work, "tampered")
        shutil.copytree(bundles[0], tampered)
        io_path = os.path.join(tampered, "batches", str(BATCHES[-1]),
                               "io.npz")
        with open(io_path, "r+b") as f:
            f.seek(os.path.getsize(io_path) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0xFF]))
        *replays, (rc, result, replay_s, err) = replay_clis(
            bundles + [tampered])
        for row, (name, prec), (rc_b, res_b, s_b, err_b) in zip(
                rows, REPLAY_BUNDLES, replays):
            ok = (rc_b == 0 and res_b is not None
                  and res_b["divergences"] == []
                  and res_b["device"] == DEVICE
                  and res_b["fingerprint_match"]
                  and sorted(res_b["batches"]) == sorted(BATCHES))
            if not ok:
                failures.append([name, prec, rc_b, res_b, err_b])
            emit({"phase": "replay", **row, "replay_exit": rc_b,
                  "replay_s": s_b,
                  "divergences": res_b and res_b["divergences"],
                  "ok": ok})
        tamper_ok = rc == 2 and "tampered" in err
        if not tamper_ok:
            failures.append(["tampered", rc, err])
        seconds = time.perf_counter() - t_phase
        emit({"phase": "replay", "tampered": os.path.relpath(io_path, work),
              "replay_exit": rc, "replay_s": replay_s,
              "stderr": err.strip()[-300:], "seconds": seconds,
              "failures": failures, "ok": not failures})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return [f"replay phase failed: {failures}"] if failures else []


#: The default pipeline up to the quantize pass (its input graph).
PRE_QUANTIZE = ("canonicalize", "fold_constants", "fuse_pad",
                "fuse_activation", "fold_batchnorm", "fuse_activation.post_bn")


def phase_time_models(torch, exes, inputs, per_model):
    from repro_torch.table1_models import SUITE
    for name in SUITE:
        for b in BATCHES:
            x = inputs[name, b]
            row = {"phase": "time", "model": name, "batch": b}
            xt = torch.as_tensor(x, device=DEVICE)
            for key in (("interpret", "exact"), ("jit", "exact"),
                        ("cuda", "exact"), ("cuda", "fast")):
                exe = exes[(name,) + key]
                tag = "_".join(key)
                # Captured programs under the existing keys; the eager
                # walk of the same prepared program beside them.
                row[tag + "_ms"] = host_median_ms(lambda: exe(input=xt))
                if key[0] != "interpret":
                    row[tag + "_eager_ms"] = host_median_ms(
                        lambda: eager_call(exe, {"input": xt}))
            exe = exes[name, "cuda", "exact"]
            row["cuda_exact_device_ms"] = device_ms(lambda: exe(input=xt))
            exe_f = exes[name, "cuda", "fast"]
            row["cuda_fast_device_ms"] = device_ms(lambda: exe_f(input=xt))
            row["cuda_exact_queued_ms"] = queued_ms(
                lambda: exe(input=xt), iters=5, spin=400_000_000)
            for tag in ("cuda_exact", "cuda_fast"):
                if row[tag + "_device_ms"] is not None:
                    row[tag + "_device_busy"] = (row[tag + "_device_ms"]
                                                 / row[tag + "_ms"])
                    row[tag + "_eager_device_busy"] = (
                        row[tag + "_device_ms"] / row[tag + "_eager_ms"])
            row["interpret_over_cuda"] = row["interpret_exact_ms"] / row["cuda_exact_ms"]
            row["interpret_over_jit"] = row["interpret_exact_ms"] / row["jit_exact_ms"]
            row["launches_per_inference"] = {
                p: {k: v for k, v in per_model[name, b, p].items()
                    if k != "expected"} for p in ("exact", "fast")}
            emit(row)


def phase_time_kernels(torch, np, exes):
    import torch.nn.functional as F
    from repro_torch.kernels.fast_act import ref as fa_ref
    from repro_torch.kernels.fast_act.ops import fast_act
    from repro_torch.kernels.fused_matmul import kernel as fm_k
    from repro_torch.kernels.fused_matmul import ref as fm_ref
    from repro_torch.kernels.fused_matmul.ops import fused_matmul
    from repro_torch.table1_models import SUITE

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(5)
    rows = {"fused_matmul": [], "fast_act": []}
    saved = (fused_matmul.launches, fast_act.launches)
    # What the timing itself costs: one empty kernel between the same
    # events, after the same flush, as every kernel row below.
    emit({"phase": "time", "kernel": "launch_floor",
          "ms": cold_ms(lambda: torch.cuda._sleep(0)),
          "what": "torch.cuda._sleep(0) timed as cold_ms times a kernel"})
    for name in SUITE:
        exe = exes[name, "cuda", "exact"]
        g = exe.graph
        specs = g.infer_shapes()
        for node in g.nodes:
            if node.op != "dense":
                continue
            w = exe.params[node.params["kernel"]]
            layout = node.attrs.get("kernel_layout", "io")
            k = specs[node.inputs[0]].shape[-1]
            n = w.shape[1] if layout == "io" else w.shape[0]
            b = exe.params[node.params["bias"]] if "bias" in node.params else None
            fn = node.epilogue if node.epilogue not in (None, "linear") else None
            pa = node.epilogue_attrs.get("post_affine")
            s, o = (exe.params[pa[0]], exe.params[pa[1]]) if pa else (None, None)
            if fn not in (None, "relu"):
                raise SystemExit(f"{name} {node.name}: no library yardstick "
                                 f"for the {fn} epilogue")
            w_lin = w if layout == "oi" else w.T
            act = F.relu if fn == "relu" else (lambda y: y)
            aff = (lambda y: y * s + o) if pa else (lambda y: y)
            for m in BATCHES:
                x = torch.tensor(rng.standard_normal((m, k)),
                                 dtype=torch.float32, device=dev)
                ms = cold_ms(lambda: fused_matmul(x, w, b, s, o, fn=fn,
                                                  w_layout=layout))
                call = cuda_ms(lambda: fused_matmul(x, w, b, s, o, fn=fn,
                                                    w_layout=layout))
                plain = cold_ms(lambda: fm_ref.fused_matmul_ref(
                    x, w, b, s, o, fn=fn, w_layout=layout))
                lib = cold_ms(lambda: aff(act(F.linear(x, w_lin, b))))
                vecs = sum(v is not None for v in (b, s, o))
                nbytes = 4 * (m * k + k * n + vecs * n + m * n)
                bnd, by = bound_ms(nbytes, 2.0 * m * k * n)
                row = {"phase": "time", "kernel": "fused_matmul",
                       "model": name, "node": node.name, "M": m, "K": k,
                       "N": n, "layout": layout, "epilogue": fn or "none",
                       "plan": fm_k.plan(m, k, n, w_layout=layout).describe(),
                       "ms": ms, "call_ms": call, "plain_ms": plain,
                       "library_ms": lib, "bound_ms": bnd, "bound_by": by}
                rows["fused_matmul"].append(row)
                emit(row)
        src = SUITE[name]()   # every softmax's exp, at its input's shape
        src_specs = src.infer_shapes()
        for node in src.nodes:
            if node.op != "softmax":
                continue
            shape = tuple(src_specs[node.inputs[0]].shape)
            for m in BATCHES:
                x = torch.tensor(rng.standard_normal((m,) + shape),
                                 dtype=torch.float32, device=dev)
                ms = cold_ms(lambda: fast_act(x, "exp"))
                call = cuda_ms(lambda: fast_act(x, "exp"))
                plain = cold_ms(lambda: fa_ref.schraudolph_exp(x))
                lib = cold_ms(lambda: torch.exp(x))
                y = torch.empty_like(x)   # the same bytes moved, no math
                copy = cold_ms(lambda: y.copy_(x))
                nel = x.numel()
                # clamp (2), multiply, add, convert per element
                bnd, by = bound_ms(8.0 * nel, 5.0 * nel)
                row = {"phase": "time", "kernel": "fast_act", "fn": "exp",
                       "model": name, "node": node.name, "shape": [m, *shape],
                       "ms": ms, "call_ms": call, "plain_ms": plain,
                       "library_ms": lib, "copy_ms": copy, "bound_ms": bnd,
                       "bound_by": by,
                       "achieved_tb_per_s": 8.0 * nel / (ms * 1e-3) / 1e12}
                rows["fast_act"].append(row)
                emit(row)
    torch.cuda.synchronize()
    fused_matmul.launches, fast_act.launches = saved
    return rows


def phase_time_paths(torch, exes, inputs, dec_exes, dec_feeds, cuda_feeds):
    """Host medians of the int8, bf16 and decode compiles, captured and
    eager (the per-model rows of path 1 are ``phase_time_models``')."""
    from repro_torch.table1_models import SUITE
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # as path A was captured
    for prec, models in (("int8", INT8_MODELS), ("bf16", tuple(SUITE))):
        for name in models:
            for b in BATCHES:
                xt = torch.as_tensor(inputs[name, b], device=DEVICE)
                row = {"phase": "time", "path": "A", "model": name,
                       "batch": b, "precision": prec}
                for target in ("cuda", "jit"):
                    exe = exes[name, target, prec]
                    row[f"{target}_ms"] = host_median_ms(lambda: exe(input=xt))
                    row[f"{target}_eager_ms"] = host_median_ms(
                        lambda: eager_call(exe, {"input": xt}))
                exe = exes[name, "cuda", prec]
                row["cuda_device_ms"] = device_ms(lambda: exe(input=xt))
                if row["cuda_device_ms"] is not None:
                    row["cuda_device_busy"] = row["cuda_device_ms"] / row["cuda_ms"]
                emit(row)
    torch.backends.cudnn.deterministic = prev
    for b, feeds in dec_feeds.items():
        row = {"phase": "time", "path": "B", "batch": b, "shape": DECODE}
        for p in ("exact", "fast"):
            exe, f = dec_exes["cuda", p], cuda_feeds[p, b]
            row[f"cuda_{p}_ms"] = host_median_ms(lambda: exe(**f), runs=10)
            row[f"cuda_{p}_eager_ms"] = host_median_ms(
                lambda: eager_call(exe, f), runs=10)
        exe = dec_exes["interpret", "exact"]
        row["interpret_exact_ms"] = host_median_ms(lambda: exe(**feeds),
                                                   runs=10)
        exe, f = dec_exes["cuda", "exact"], cuda_feeds["exact", b]
        row["cuda_exact_device_ms"] = device_ms(lambda: exe(**f), iters=5)
        if row["cuda_exact_device_ms"] is not None:
            row["cuda_exact_device_busy"] = (row["cuda_exact_device_ms"]
                                             / row["cuda_exact_ms"])
        emit(row)


def phase_time_q8(torch, np, exes):
    """fused_matmul_q8 at every int8 dense node of path A, batch 1 and
    256: the kernel, its plain version, ``torch._int_mm`` where its shape
    rules allow it (the integer product alone), and the bound."""
    from repro_torch.core.lowering import quant_key
    from repro_torch.kernels import qmath
    from repro_torch.kernels.fused_matmul import kernel as fm_k
    from repro_torch.kernels.fused_matmul import ref as fm_ref
    from repro_torch.kernels.fused_matmul.ops import fused_matmul_q8

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(6)
    rows = []
    saved = fused_matmul_q8.launches
    for name in INT8_MODELS:
        exe = exes[name, "cuda", "int8"]
        g = exe.graph
        specs = g.infer_shapes()
        for node in g.nodes:
            if node.op != "dense":
                continue
            p = exe.params
            wq, deq = p[quant_key(node, "wq")], p[quant_key(node, "deq")]
            xs, xs_t = node.attrs["quant.x_scale"], p[quant_key(node, "x_scale")]
            layout = node.attrs.get("kernel_layout", "io")
            k = specs[node.inputs[0]].shape[-1]
            n = wq.shape[1] if layout == "io" else wq.shape[0]
            b = p[node.params["bias"]] if "bias" in node.params else None
            fn = node.epilogue if node.epilogue not in (None, "linear") else None
            pa = node.epilogue_attrs.get("post_affine")
            s, o = (p[pa[0]], p[pa[1]]) if pa else (None, None)
            w_kn = wq if layout == "io" else wq.T
            for m in BATCHES:
                x = torch.tensor(rng.standard_normal((m, k)),
                                 dtype=torch.float32, device=dev)
                kw = dict(fn=fn, w_layout=layout)
                ms = cold_ms(lambda: fused_matmul_q8(x, wq, deq, b, s, o,
                                                     x_scale=xs, **kw))
                call = cuda_ms(lambda: fused_matmul_q8(x, wq, deq, b, s, o,
                                                       x_scale=xs, **kw))
                plain = cold_ms(lambda: fm_ref.fused_matmul_q8_ref(
                    qmath.quantize_q8(x, xs_t), wq, deq, b, s, o, **kw))
                xq = qmath.quantize_q8(x, xs_t)
                try:
                    lib, lib_note = cold_ms(lambda: torch._int_mm(xq, w_kn)), \
                        "torch._int_mm (int8 operands, int32 out)"
                except RuntimeError as e:
                    lib, lib_note = None, f"torch._int_mm refused: {str(e)[:80]}"
                vecs = sum(v is not None for v in (b, s, o))
                nbytes = 4 * m * k + k * n + 4 * n * (1 + vecs) + 4 * m * n
                bnd, by = bound_ms(nbytes, 2.0 * m * k * n, INT8_OPS_PER_S)
                row = {"phase": "time", "kernel": "fused_matmul_q8",
                       "model": name, "node": node.name, "M": m, "K": k,
                       "N": n, "layout": layout, "epilogue": fn or "none",
                       "plan": fm_k.plan_q8(m, k, n,
                                            w_layout=layout).describe(),
                       "ms": ms, "call_ms": call, "plain_ms": plain,
                       "library_ms": lib, "library": lib_note,
                       "bound_ms": bnd, "bound_by": by}
                rows.append(row)
                emit(row)
    torch.cuda.synchronize()
    fused_matmul_q8.launches = saved
    return rows


def phase_time_decode(torch, dec_feeds):
    """decode_attention at path B's inputs: the kernel, the tiled plain
    form, the library's masked GQA ``scaled_dot_product_attention``, and
    the bound (K and V up to each length read once, q read and the
    output written once; 4·H·D operations per valid row)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as attn_k
    from repro_torch.kernels.decode_attention import ref as attn_ref
    from repro_torch.kernels.decode_attention.ops import decode_attention

    rows = []
    saved = decode_attention.launches
    h, hkv, d, s = DECODE["h"], DECODE["hkv"], DECODE["d"], DECODE["s"]
    for b, f in dec_feeds.items():
        q, k, v, lens = f["q"], f["k"], f["v"], f["lengths"]
        ms = cold_ms(lambda: decode_attention(q, k, v, lens), iters=10)
        call = cuda_ms(lambda: decode_attention(q, k, v, lens), iters=10,
                       warmup=2)
        # The same kernel with scalar loads: K and V copied one float off
        # 16-byte alignment, which rules out its float4 path.
        k1, v1 = (torch.empty(t.numel() + 1, device=DEVICE)[1:].view(t.shape)
                  .copy_(t) for t in (k, v))
        scalar = cold_ms(lambda: decode_attention(q, k1, v1, lens), iters=10)
        del k1, v1
        plain = cold_ms(lambda: attn_ref.decode_attention_tiled(q, k, v, lens),
                        iters=5, warmup=1)
        mask = (torch.arange(s, device=DEVICE)[None, :]
                < lens[:, None])[:, None, None, :]
        q4, k4, v4 = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        try:
            lib = cold_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, enable_gqa=True), iters=5, warmup=1)
            lib_note = "F.scaled_dot_product_attention(enable_gqa, bool mask)"
        except RuntimeError as e:
            lib, lib_note = None, f"sdpa refused: {str(e)[:80]}"
        rows_valid = sum(DECODE_LENGTHS[b])
        nbytes = 2 * rows_valid * hkv * d * 4 + 2 * b * h * d * 4 + 4 * b
        bnd, by = bound_ms(nbytes, 4.0 * h * d * rows_valid)
        tpc, chunks = attn_k.chunk_plan(b, hkv, s)
        # Device time of each of the call's kernels (warm L2), by name.
        split = {}
        for name, t in device_ms_by_kernel(
                lambda: decode_attention(q, k, v, lens), 5).items():
            part = next((p for p in ("scores", "pv", "combine")
                         if f"{p}_kernel" in name), name[:60])
            split[part] = split.get(part, 0.0) + t
        row = {"phase": "time", "kernel": "decode_attention", "batch": b,
               "shape": DECODE, "lengths": DECODE_LENGTHS[b],
               "plan": f"{tpc} tiles a chunk, {chunks} chunks x {b * hkv} "
                       f"(batch, KV head): {b * hkv * chunks} blocks; "
                       f"{attn_k.KERNELS_PER_CALL} kernels a call", "ms": ms,
               "call_ms": call, "kernels_device_ms": split,
               "scalar_loads_ms": scalar,
               "plain_ms": plain, "library_ms": lib,
               "library": lib_note, "bound_ms": bnd, "bound_by": by}
        rows.append(row)
        emit(row)
    torch.cuda.synchronize()
    decode_attention.launches = saved
    return rows


# ---------------------------------------------------------------------------
# The engine phase (a child process: ``python3 chip_smoke.py --engine``)
# ---------------------------------------------------------------------------
BF16_FLOPS_PER_S = 989e12        # bf16 tensor-core peak, dense
#: Every config the engine target runs, at SMOKE size in (a).
ENGINE_ARCHS = ("qwen2.5-14b", "deepseek-7b", "gemma3-27b", "minicpm-2b",
                "deepseek-v3-671b", "mixtral-8x22b", "internvl2-2b",
                "mamba2-780m", "recurrentgemma-9b", "whisper-base")
#: Card against CPU at f32, relative to max(1, max|logits|) (the
#: reference's own f32 decode-vs-forward test holds 1e-4).
ENGINE_F32_TOL = 1e-4
#: Prefill and decode against the forward at the published widths, f32:
#: sums over 512-16384 terms in another order and up to 48 layers deep
#: (mamba2's chunked SSD also takes exp of differences of f32 cumulative
#: log-decays that reach ~10^3 within a 256-token chunk).
ENGINE_DECODE_TOL = 1e-3
ENGINE_SMOKE = (2, 24, 8)        # batch, prompt, greedy decode steps
#: The configs run whole, as published, made on the card from seed 0:
#: their parameter count, the consistency check (batch, prompt, greedy
#: steps), and the deep decode point (batch, max_len, position): qwen's
#: decode_32k (its batch of 128 cut to 4: a 25.77 GB K/V cache), and
#: long_500k's last position for the two archs that run it
#: (``LONG_CONTEXT_OK``).  mamba2's prompt is not a multiple of its
#: 256-token chunk; recurrentgemma's 2040 tokens and 16 steps pass its
#: 2048-row ring.
ENGINE_WHOLE = {
    "qwen2.5-14b": (14_770_033_664, (2, 64, 8), (4, 32768, 32768 - 12)),
    "mamba2-780m": (780_148_992, (2, 300, 8), (1, 524288, 524287)),
    "recurrentgemma-9b": (9_396_195_328, (1, 2040, 16), (1, 524288, 524287)),
    "whisper-base": (70_686_208, (2, 64, 8), None),
}
#: The timing rows of each: prefill (batch, tokens), decode batches over
#: a prompt of LLM_DECODE_PROMPT tokens in a cache of LLM_MAX_LEN rows.
LLM_PREFILL = (4, 512)
#: The engine_forward row's first shape: captured before LLM_PREFILL's,
#: which then lays the executable's pool out again.
ENGINE_FORWARD_FIRST = (2, 256)
LLM_DECODE = (1, 8)
LLM_MAX_LEN = 2048
LLM_DECODE_PROMPT = 128
#: mixtral-8x22b at its widths, 2 of 56 layers: a prompt 6 short of the
#: 4096 window, then 16 steps, so the ring cache wraps.
MIXTRAL_LAYERS = 2
MIXTRAL_CHECK = (1, 4090, 16)
ENGINE_TIMEOUT_S = 600
#: Cache leaves laid out (..., batch, rows, ...) that a step reads only up
#: to its position (K/V rows); whisper's cross K/V are read whole and
#: never written; every other leaf but ``pos`` is state, read and written.
_KV_LEAVES = ("c1", "c2", "attn_k", "attn_v", "k", "v")
_CROSS_LEAVES = ("xk", "xv")


def _rel_err(got, want):
    """(max |got - want|, max(1, max |want|)) as floats."""
    want = want.float()
    return (float((got.float().to(want.device) - want).abs().max()),
            max(1.0, float(want.abs().max())))


def _greedy(torch, model, params, batch, steps, max_len, device):
    """Prefill then ``steps`` greedy decode steps: (tokens (B, steps),
    logits (B, steps + 1, V) of prefill and each step)."""
    b = batch["tokens"].shape[0]
    cache = model.init_cache(b, max_len, device)
    lg, cache = model.prefill(params, batch, cache)
    logits, toks = [lg[:, -1]], []
    for _ in range(steps):
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok)
        lg, cache = model.decode_step(params, cache, tok)
        logits.append(lg[:, -1])
    return torch.cat(toks, 1), torch.stack(logits, 1), cache


def _peak_gb(torch) -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def _smoke_batch(np, cfg, b, s):
    """Seeded tokens, and the family's extra input (patches, frames)."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.vit_dim)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def phase_engine_smoke(torch, np):
    """(a) Each SMOKE config through ``target="engine"`` on the card and
    on the CPU, with the same weights (made on the CPU from a seed, moved
    to the card): f32 forward logits, prefill plus greedy decode, and
    forward at the configured bf16."""
    import dataclasses
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    problems = []
    b, s, steps = ENGINE_SMOKE
    for arch in ENGINE_ARCHS:
        t0 = time.perf_counter()
        base = get_config(arch, smoke=True)
        params = get_model(base).init(0, "cpu")
        batch = _smoke_batch(np, base, b, s)
        row = {"phase": "engine", "case": "smoke", "arch": arch}
        for dtype in ("float32", base.dtype):
            cfg = dataclasses.replace(base, dtype=dtype)
            exes = {dev: repro_torch.compile(
                cfg, repro_torch.CompileOptions(target="engine", device=dev),
                params=params) for dev in ("cpu", DEVICE)}
            torch.cuda.reset_peak_memory_stats()
            want = exes["cpu"](**batch)["logits"]
            got = exes[DEVICE](**batch)["logits"]
            assert got.device.type == torch.device(DEVICE).type
            captured = exes[DEVICE].programs["captured"]
            row[f"{dtype}_forward_captured"] = captured
            if not captured:
                problems.append(f"engine {arch} {dtype}: the card's forward "
                                f"is not a captured program")
            err, scale = _rel_err(got, want)
            tol = ENGINE_F32_TOL if dtype == "float32" else QUANT_BUDGET
            row[f"{dtype}_forward_err"] = err
            row[f"{dtype}_forward_limit"] = tol * scale
            if err > tol * scale:
                problems.append(f"engine {arch} {dtype} forward: card vs "
                                f"CPU {err} > {tol * scale}")
            if dtype == "float32":
                out = {}
                for dev, exe in exes.items():
                    feed = {k: torch.as_tensor(v, device=dev)
                            for k, v in batch.items()}
                    out[dev] = _greedy(torch, exe.model, exe.params, feed,
                                       steps, s + steps, dev)
                same = torch.equal(out[DEVICE][0].cpu(), out["cpu"][0])
                derr, _ = _rel_err(out[DEVICE][1], out["cpu"][1])
                row.update(greedy_tokens=out[DEVICE][0].tolist(),
                           greedy_equal=same, decode_err=derr)
                if not same or derr > tol * scale:
                    problems.append(f"engine {arch} greedy decode: tokens "
                                    f"equal {same}, logits err {derr}")
            row[f"{dtype}_peak_gb"] = _peak_gb(torch)
        row["seconds"] = time.perf_counter() - t0
        emit(row)
    return problems


def _cache_bytes(cache, rows, state_passes):
    """Bytes moved to and from a cache: the K/V rows up to ``rows`` (each
    ring clamped to its length), whisper's cross K/V whole, and every
    state leaf ``state_passes`` times (2 for a decode step, which reads
    and rewrites it; 1 for a prefill, which writes it)."""
    total = 0
    for name, t in cache.items():
        n = t.numel() * t.element_size()
        if name in _KV_LEAVES:
            total += n * min(rows, t.shape[2]) // t.shape[2]
        elif name in _CROSS_LEAVES:
            total += n
        elif name != "pos":
            total += state_passes * n
    return total


def _prefill_flops(cfg, params, b, s):
    """(bf16 tensor-core operations, f32 operations) of a prefill of b x s
    tokens: 2 per weight per token it multiplies (whisper's encoder and
    cross K/V over its frames; neither the embedding table nor the head,
    which runs on one position), and the attention's q.k and p.v
    (causal: half; local: the window) or the SSD's chunk products, in
    f32 (the configs' attention compute dtype).  Dense families only:
    a MoE's experts would count whole."""
    import math
    from repro_torch.models.common import tree_leaves
    n = lambda t: sum(math.prod(l.shape) for l in tree_leaves(t))
    h, hd = cfg.n_heads, cfg.head_dim
    if cfg.family == "audio":
        nf = cfg.n_frames
        cross_kv = n(params["dec"]["cross"]["wk"]) + n(
            params["dec"]["cross"]["wv"])
        mm = 2 * b * (n(params["enc"]) * nf + cross_kv * nf
                      + (n(params["dec"]) - cross_kv) * s)
        att = 4 * b * h * hd * (cfg.encoder_layers * nf * nf
                                + cfg.num_layers * (s * s / 2 + s * nf))
        return mm, att
    tables = n(params["embed"]) + n(params.get("head", {}))
    mm = 2 * b * s * (n(params) - tables)
    if cfg.family == "ssm":
        from repro_torch.models import ssm
        q = min(cfg.ssm_chunk, s)
        nh, dh, ds = ssm.n_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state
        chunks = -(-s // q)
        per_chunk = 2 * q * q * ds + 2 * nh * q * q * dh + 4 * q * nh * ds * dh
        return mm, b * chunks * per_chunk * cfg.num_layers
    if cfg.family == "hybrid":
        layers, w = cfg.num_layers // 3, min(s, cfg.window)
    else:
        layers, w = cfg.num_layers, s
    return mm, 4 * b * h * hd * layers * (s * w - w * w / 2)


def _decode_step(model, params, cache, tok, pos0):
    """One decode step on ``cache`` (each taken at position ``pos0``
    unless it is None), bound to its own cache and token."""
    def step():
        if pos0 is not None:
            cache["pos"].fill_(pos0)
        return model.decode_step(params, cache, tok)
    return step


def _llm_rows(torch, exe, label, deep=None):
    """Prefill and decode timings of an engine executable at the
    published widths: host ms around synchronised calls, the device's
    busy share (torch.profiler's device time over the host's), the
    bound, and the top device ops of one decode step.  ``deep`` is a
    decode point (batch, max_len, position) over a cache filled with
    normals, each step taken at that position."""
    cfg, model, params = exe.cfg, exe.model, exe.params
    cost = exe.cost_summary()
    wbytes = cost["param_bytes"]
    gen = torch.Generator(device=DEVICE).manual_seed(1)

    def prompt(b, s):
        batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                         device=DEVICE, dtype=torch.int32)}
        if cfg.family == "audio":
            batch["frames"] = torch.randn((b, cfg.n_frames, cfg.d_model),
                                          generator=gen, device=DEVICE)
        return batch

    with torch.inference_mode():
        b, s = LLM_PREFILL
        torch.cuda.reset_peak_memory_stats()
        batch = prompt(b, s)
        cache = model.init_cache(b, LLM_MAX_LEN, DEVICE)
        pf = lambda: model.prefill(params, batch, cache)
        ms = host_median_ms(pf, runs=3, warmup=1)
        prof = device_profile(pf, iters=1)
        dev_ms = sum(v[1] for v in prof.values())
        mm, att = _prefill_flops(cfg, params, b, s)
        t_bytes = (wbytes + _cache_bytes(cache, s, 1)) / HBM_BYTES_PER_S * 1e3
        t_ops = (mm / BF16_FLOPS_PER_S + att / F32_FLOPS_PER_S) * 1e3
        row = {"phase": "engine", "case": cfg.name, "precision": label,
               "op": "prefill", "batch": b, "tokens": s, "ms": ms,
               "tokens_per_s": b * s / ms * 1e3, "device_ms": dev_ms,
               "busy_share": dev_ms / ms,
               "launches": sum(v[0] for v in prof.values()),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "peak_gb": _peak_gb(torch)}
        if cfg.family == "audio":
            row["frames"] = cfg.n_frames
        emit(row)
        del cache, pf, batch
        points = [(bb, LLM_MAX_LEN, None) for bb in LLM_DECODE]
        if deep:
            points.append(deep)
        short = None        # the short-depth step at the deep point's batch
        for bb, max_len, pos0 in points:
            torch.cuda.reset_peak_memory_stats()
            cache = model.init_cache(bb, max_len, DEVICE)
            if pos0 is None:
                model.prefill(params, prompt(bb, LLM_DECODE_PROMPT), cache)
            else:           # a deep point: every leaf filled with normals
                for leaf in cache.values():
                    if leaf.is_floating_point():
                        for part in leaf:          # a layer at a time
                            part.normal_(generator=gen)
            step = _decode_step(model, params, cache, prompt(bb, 1)["tokens"],
                                pos0)
            ms = host_median_ms(step, runs=10 if pos0 is None else 5,
                                warmup=2)
            prof = device_profile(step, iters=2)
            busy = sum(v[1] for v in prof.values())
            depth = int(cache["pos"][0]) - 1     # the last step's position
            moved = _cache_bytes(cache, depth + 1, 2)
            top = sorted(prof.items(), key=lambda kv_: -kv_[1][1])[:10]
            row = {"phase": "engine", "case": cfg.name,
                   "precision": label, "op": "decode", "batch": bb,
                   "depth": depth, "ms": ms, "tokens_per_s": bb / ms * 1e3,
                   "device_ms": busy, "busy_share": busy / ms,
                   "launches": sum(v[0] for v in prof.values()),
                   "bound_ms": (wbytes + moved) / HBM_BYTES_PER_S * 1e3,
                   "bound_by": "bytes",
                   "weight_gb": wbytes / 1e9, "cache_gb": moved / 1e9,
                   "peak_gb": _peak_gb(torch),
                   "top_ops": [{"name": k[:120], "launches": n, "ms": t}
                               for k, (n, t) in top]}
            if pos0 is None and deep and bb == deep[0]:
                short = step
            elif pos0 is not None and short is not None:
                # The deep step against the short one in turns (short,
                # deep, deep, short): host medians move between windows.
                turns = [host_median_ms(f, runs=5, warmup=1)
                         for f in (short, step, step, short)]
                row["turns_ms"] = {"short": [turns[0], turns[3]],
                                   "deep": [turns[1], turns[2]]}
            emit(row)
            del cache, step


def phase_engine_whole(torch, arch):
    """(b) qwen2.5-14b, (d) mamba2-780m, (e) recurrentgemma-9b and (f)
    whisper-base, each the whole published config made on the card from
    seed 0: prefill and greedy decode against the forward at f32, then
    the timing rows at bf16 activations with f32 masters ("exact") and
    with bf16 weights ("bf16")."""
    import dataclasses
    import gc
    import repro_torch
    from repro_torch.configs import get_config
    problems = []
    want_params, (b, s, steps), deep = ENGINE_WHOLE[arch]
    cfg = get_config(arch)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    exe32 = repro_torch.compile(
        dataclasses.replace(cfg, dtype="float32"),
        repro_torch.CompileOptions(target="engine", device=DEVICE),
        init_seed=0)
    cost = exe32.cost_summary()
    init_s = time.perf_counter() - t0
    if cost["params"] != want_params:
        problems.append(f"{arch} has {cost['params']} parameters, not "
                        f"{want_params}")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device=DEVICE, dtype=torch.int32)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((b, cfg.n_frames, cfg.d_model),
                                      generator=gen, device=DEVICE)
    with torch.inference_mode():
        toks, logits, cache = _greedy(torch, exe32.model, exe32.params,
                                      batch, steps, s + steps, DEVICE)
        full = exe32(**dict(batch, tokens=torch.cat(
            [batch["tokens"], toks], 1)))["logits"]
    if not exe32.programs["captured"]:
        problems.append(f"{arch}: the f32 forward is not a captured program")
    want = full[:, s - 1:s + steps]
    err, scale = _rel_err(logits, want)
    same = torch.equal(toks, want[:, :steps].argmax(-1).to(torch.int32))
    last = int(cache["pos"][0])
    row = {"phase": "engine", "case": arch, "op": "decode_vs_forward",
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "params": cost["params"], "param_bytes_f32": cost["param_bytes"],
           "batch": b, "prompt": s, "steps": steps, "last_pos": last,
           "max_abs_err": err, "limit": ENGINE_DECODE_TOL * scale,
           "greedy_equal": same, "tokens": toks.tolist(), "init_s": init_s,
           "peak_gb": _peak_gb(torch)}
    ok = err <= ENGINE_DECODE_TOL * scale and same
    if cfg.family == "ssm":
        row["chunk"] = cfg.ssm_chunk
        ok &= s % cfg.ssm_chunk != 0            # the padded chunk ran
    if cfg.family == "hybrid":
        row["ring"] = cache["attn_k"].shape[2]
        ok &= last > row["ring"]                # the ring wrapped
    if cfg.family == "audio":
        row["frames"] = cfg.n_frames
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    if not ok:
        problems.append(f"{arch} decode vs forward: err {err} (limit "
                        f"{ENGINE_DECODE_TOL * scale}), greedy tokens equal "
                        f"{same}, last position {last}")
    del full, want, logits, cache
    # The config as published (bf16 activations) over the f32 masters:
    # the same tensors, cast at each product as the reference does.
    exe = repro_torch.compile(cfg, repro_torch.CompileOptions(
        target="engine", device=DEVICE), params=exe32.params)
    del exe32
    _llm_rows(torch, exe, "exact")
    del exe
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    exe = repro_torch.compile(cfg, repro_torch.CompileOptions(
        target="engine", precision="bf16", device=DEVICE), init_seed=0)
    emit({"phase": "engine", "case": arch, "op": "bf16_compile",
          "seconds": time.perf_counter() - t0,
          "param_bytes": exe.cost_summary()["param_bytes"],
          "quant": exe.quant_report, "peak_gb": _peak_gb(torch)})
    _llm_rows(torch, exe, "bf16", deep=deep)
    if arch == "qwen2.5-14b":
        problems += _engine_forward(torch, exe)
    del exe
    gc.collect()
    torch.cuda.empty_cache()
    return problems


def _engine_forward(torch, exe):
    """The forward through ``exe(...)``, one captured program per input
    signature: ENGINE_FORWARD_FIRST's shape, then LLM_PREFILL's (which
    lays the pool out again, largest first), the growth of
    ``memory_reserved`` over both captures against the larger program's
    pool; then the LLM_PREFILL replay against ``model.forward`` run
    eagerly on the same params and batch, its host and device ms,
    launches, busy share and bound, beside the eager forward's ms."""
    from repro_torch.models.common import tree_leaves
    cfg, model, params = exe.cfg, exe.model, exe.params
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    batches = [{"tokens": torch.randint(0, cfg.vocab, shape, generator=gen,
                                        device=DEVICE, dtype=torch.int32)}
               for shape in (ENGINE_FORWARD_FIRST, LLM_PREFILL)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    for batch in batches:
        exe(**batch)             # captured, its logits dropped at once
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    growth = torch.cuda.memory_reserved() - reserved0
    progs = sorted(exe._programs.values(), key=lambda p: p.order)
    inputs = sum(t.numel() * t.element_size() for p in progs
                 for t in p.inputs.values())
    limit = (progs[-1].pool_bytes + inputs) * (1 + POOL_SLACK)
    batch = batches[-1]
    with torch.inference_mode():
        got = exe(**batch)["logits"]
        want = model.forward(params, batch)[0]
    equal = torch.equal(got, want)
    del got, want
    call = lambda: exe(**batch)
    eager = lambda: model.forward(params, batch)
    with torch.inference_mode():
        turns = [host_median_ms(f, runs=3, warmup=1)
                 for f in (eager, call, call, eager)]
        prof = device_profile(call, iters=1)
        eager_prof = device_profile(eager, iters=1)
    dev_ms = sum(v[1] for v in prof.values())
    ms = statistics.median(turns[1:3])
    b, s = LLM_PREFILL
    n = lambda t: sum(math.prod(l.shape) for l in tree_leaves(t))
    mm, att = _prefill_flops(cfg, params, b, s)
    head = 2 * b * s * cfg.vocab * cfg.d_model      # every position, f32
    wbytes = exe.cost_summary()["param_bytes"]
    t_bytes = (wbytes + b * s * cfg.vocab * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = (mm / BF16_FLOPS_PER_S + (att + head) / F32_FLOPS_PER_S) * 1e3
    summary = exe.programs
    row = {"phase": "engine", "case": "engine_forward", "arch": cfg.name,
           "precision": exe.options.precision, "batch": b, "tokens": s,
           "first_shape": list(ENGINE_FORWARD_FIRST),
           "programs": summary["programs"], "captured": summary["captured"],
           "replay_bit_equal": equal, "ms": ms, "turns_ms": {
               "eager": [turns[0], turns[3]], "replay": turns[1:3]},
           "eager_ms": statistics.median([turns[0], turns[3]]),
           "device_ms": dev_ms, "busy_share": dev_ms / ms,
           "launches": sum(v[0] for v in prof.values()),
           "eager_device_ms": sum(v[1] for v in eager_prof.values()),
           "eager_launches": sum(v[0] for v in eager_prof.values()),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "pool_bytes": summary["pool_bytes"],
           "program_pool_bytes": [p.pool_bytes for p in progs],
           "reserved_growth": growth, "growth_limit": limit,
           "params": n(params), "peak_gb": _peak_gb(torch)}
    emit(row)
    problems = []
    if not (equal and summary["captured"] and summary["programs"] == 2
            and growth <= limit and row["launches"] > 0):
        problems.append(
            f"engine_forward: replay bit-equal {equal}, captured "
            f"{summary['captured']}, {summary['programs']} programs, "
            f"reserved growth {growth} (limit {limit}), "
            f"{row['launches']} launches a replay")
    return problems


def phase_engine_mixtral(torch):
    """(c) mixtral-8x22b at its widths, 2 of 56 layers, f32 with moe_cf 8
    (the reference's decode-vs-forward test): a 4090-token prompt and 16
    greedy steps, past the 4096-token window, so the ring cache wraps."""
    import dataclasses
    import gc
    import repro_torch
    from repro_torch.configs import get_config
    problems = []
    cfg = dataclasses.replace(get_config("mixtral-8x22b"),
                              num_layers=MIXTRAL_LAYERS, dtype="float32",
                              moe_cf=8.0)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    exe = repro_torch.compile(cfg, repro_torch.CompileOptions(
        target="engine", device=DEVICE), init_seed=0)
    b, s, steps = MIXTRAL_CHECK
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                           device=DEVICE, dtype=torch.int32)
    with torch.inference_mode():
        toks, logits, cache = _greedy(torch, exe.model, exe.params,
                                      {"tokens": prompt}, steps, s + steps,
                                      DEVICE)
        full = exe(tokens=torch.cat([prompt, toks], 1))["logits"]
    if not exe.programs["captured"]:
        problems.append("mixtral: the forward is not a captured program")
    want = full[:, s - 1:s + steps]
    err, scale = _rel_err(logits, want)
    same = torch.equal(toks, want[:, :steps].argmax(-1).to(torch.int32))
    ring, last = cache["c1"].shape[2], int(cache["pos"][0])
    emit({"phase": "engine", "case": "mixtral-8x22b",
          "op": "decode_vs_forward", "layers": cfg.num_layers,
          "reduced": "num_layers 56 -> 2",
          "params": exe.cost_summary()["params"], "batch": b, "prompt": s,
          "steps": steps, "ring": ring, "last_pos": last,
          "max_abs_err": err, "limit": ENGINE_DECODE_TOL * scale,
          "greedy_equal": same, "peak_gb": _peak_gb(torch),
          "seconds": time.perf_counter() - t0})
    if err > ENGINE_DECODE_TOL * scale or not same or last <= ring:
        problems.append(f"mixtral decode vs forward: err {err} (limit "
                        f"{ENGINE_DECODE_TOL * scale}), greedy tokens equal "
                        f"{same}, ring {ring} last position {last}")
    del exe, full, want, logits, cache
    gc.collect()
    torch.cuda.empty_cache()
    return problems


def engine_main() -> int:
    """The engine phase, alone in this process so that it has the card's
    memory to itself: qwen2.5-14b's f32 masters take 59.08 GB."""
    import torch
    import numpy as np
    if not torch.cuda.is_available():
        print("chip_smoke --engine: no CUDA device", file=sys.stderr)
        return 2
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("TF32 is on; the f32 comparisons need it off")
    free, total = torch.cuda.mem_get_info()
    emit({"phase": "engine", "case": "start", "free_gb": free / 1e9,
          "total_gb": total / 1e9})
    problems = phase_engine_smoke(torch, np)
    problems += phase_engine_whole(torch, "qwen2.5-14b")
    problems += phase_engine_mixtral(torch)
    for arch in ("mamba2-780m", "recurrentgemma-9b", "whisper-base"):
        problems += phase_engine_whole(torch, arch)
    if problems:
        raise SystemExit("engine phase failed: " + "; ".join(problems))
    return 0


def start_child(flag: str, timeout_s: float, env=None):
    """Start a phase in a child process (``python3 chip_smoke.py
    <flag>``, in ``env`` where given), killed ``timeout_s`` after it
    starts; :func:`finish_child` passes its lines on."""
    import threading
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             flag], cwd=ROOT, stdout=subprocess.PIPE,
                            text=True, env=env)
    watchdog = threading.Timer(timeout_s, proc.kill)
    watchdog.start()
    return proc, watchdog, time.perf_counter(), timeout_s


def finish_child(child, name: str):
    """Pass a started child's lines on as they come, wait for it, and
    report it: its problems."""
    proc, watchdog, t0, timeout_s = child
    try:
        for line in proc.stdout:
            line = line.rstrip("\n")
            try:
                emit(json.loads(line))
            except ValueError:
                print(line, flush=True)
        rc = proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    problems = []
    seconds = time.perf_counter() - t0
    if seconds >= timeout_s:
        problems.append(f"{name} phase killed after {seconds:.0f} s")
    if rc != 0:
        problems.append(f"{name} phase exited {rc}")
    emit({"phase": name, "case": "done", "seconds": seconds, "rc": rc})
    return problems


def phase_child(flag: str, timeout_s: float, name: str):
    """Run a phase in a child process (``python3 chip_smoke.py <flag>``),
    killed after ``timeout_s``, and pass its lines on."""
    return finish_child(start_child(flag, timeout_s), name)


def phase_engine():
    """The engine phase in its child process."""
    return phase_child("--engine", ENGINE_TIMEOUT_S, "engine")


# ---------------------------------------------------------------------------
# The serve phase (a child process: ``python3 chip_smoke.py --serve``)
# ---------------------------------------------------------------------------
#: (a) each SMOKE config served on the card and on the CPU: the
#: scheduler's options (buckets from BucketPolicy.default over them;
#: chunked prefill and the prefix cache switch themselves off where the
#: family has no incremental prefill), the requests (count, prompt
#: lengths, new tokens; uids 0, 2 and 4 share an 8-token head), how many
#: arrive after the second step, and the f32 logits limit.
SERVE_SMOKE = dict(slots=3, max_len=32, prefill_chunk=8, prefix_cache=2)
SERVE_SMOKE_REQUESTS = (5, (3, 12), 5)
SERVE_SMOKE_LATE = 2
SERVE_SMOKE_TOL = 1e-4
#: (b) qwen2.5-14b whole at bf16: the options, and the requests (count,
#: prompt lengths, how many share a head, its length, new tokens).
SERVE_QWEN = dict(slots=8, max_len=2048, prefill_chunk=256, prefix_cache=4,
                  admission="fcfs")
SERVE_QWEN_REQUESTS = (32, (64, 1024), 8, 512, 64)
#: Steady-state steps over which no buffer may move and no byte may be
#: allocated, over SERVE_QWEN's slots full of prompts of this length;
#: timed runs of one step, captured and eager, per turn.
SERVE_STEADY_STEPS = 6
SERVE_STEADY_PROMPT = 64
SERVE_TIMED_RUNS = 10
#: (c) mamba2-780m whole at f32: requests, prompt length, new tokens, and
#: the options (a chunk of 256 and length buckets ask for what an SSM
#: switches off: its state does not grow with max_len).
SERVE_MAMBA = (4, 300, 8)
SERVE_MAMBA_OPTS = dict(slots=4, max_len=512, prefill_chunk=256)
#: (d) whisper-base whole at f32, served through its length buckets'
#: padded-prefill programs on the card and on the CPU (the same weights,
#: made on the CPU from a seed): the options (Whisper's text context) and
#: the requests (count, prompt lengths, new tokens; each its own frames).
SERVE_WHISPER = dict(slots=4, max_len=448)
SERVE_WHISPER_REQUESTS = (4, (4, 200), 8)
#: (e) each SMOKE config served with neither chunks nor length buckets,
#: at (a)'s slots and max_len: the prompts' lengths (two equal; none
#: shorter than internvl2's image tokens, which an exact-length prefill
#: takes first) and new tokens, all submitted at once.
SERVE_WHOLE = ((12, 9, 12, 15), 5)
SERVE_TIMEOUT_S = 420


class _Recorder:
    """A sampler that keeps every logits row it is handed (on the host:
    on the card a decode step's logits are overwritten by the next
    replay) and returns the argmax."""

    def __init__(self):
        self.rows = {}

    def __call__(self, logits, temperature, *, uid, index):
        row = logits.detach().float().cpu()
        self.rows[(uid, index)] = row
        return int(row.argmax(-1)[0])


def _replays_cover_steps(sched):
    """(every step a captured graph, its calls summed == decode steps)."""
    steps = sched.decode_steps()
    return (all(s.graph is not None for s in steps),
            sum(s.calls for s in steps) == sched.metrics.decode_steps)


def _engine_problems(label, engines):
    """The card's rule for ``summary()["engines"]``: every prefill
    program a scheduler runs (the chunk program, each length bucket's,
    each prompt length's whole-prompt program) is a CUDA graph, on a
    mesh too: the scheduler prefills whole on every rank and its prefill
    talks to no other rank."""
    bad = [n for n in ("chunk", "prefill", "whole_prefill")
           if n in engines and not engines[n]["captured"]]
    return [f"{label}: engines {bad} against the rule ({engines})"] \
        if bad else []


def _serve_smoke_requests(np, cfg):
    from repro_torch.serve import Request
    n, (lo, hi), new = SERVE_SMOKE_REQUESTS
    rng = np.random.default_rng(0)
    head = rng.integers(0, cfg.vocab, 8).astype(np.int32)
    reqs = []
    for uid in range(n):
        p = rng.integers(0, cfg.vocab, int(rng.integers(lo, hi + 1)))
        p = p.astype(np.int32)
        if uid % 2 == 0:
            p = np.concatenate([head, p])[:SERVE_SMOKE["max_len"] - new - 1]
        inputs = None
        if cfg.family == "audio":
            inputs = {"frames": rng.standard_normal(
                (cfg.n_frames, cfg.d_model)).astype(np.float32)}
        if cfg.family == "vlm":
            inputs = {"patches": rng.standard_normal(
                (cfg.num_image_tokens, cfg.vit_dim)).astype(np.float32)}
        reqs.append(Request(uid=uid, prompt=p, max_new_tokens=new,
                            inputs=inputs))
    return reqs


def phase_serve_smoke(torch, np):
    """(a) Each SMOKE config at f32 served on the card and on the CPU over
    the same weights (made on the CPU from a seed): buckets on (every
    bucket captured first, so both take the same buckets), chunked
    prefill and a prefix cache where the family has them, requests
    arriving after the second step.  Tokens equal, every logits row
    within SERVE_SMOKE_TOL x max(1, max|logits|), every card step a
    replay."""
    import dataclasses
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.runtime import BucketPolicy
    from repro_torch.serve import SchedulerOptions
    problems = []
    for arch in ENGINE_ARCHS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32")
        params = get_model(cfg).init(0, "cpu")
        reqs = _serve_smoke_requests(np, cfg)
        runs = {}
        for dev in ("cpu", DEVICE):
            exe = repro_torch.compile(cfg, repro_torch.CompileOptions(
                target="engine", device=dev), params=params)
            rec = _Recorder()
            sched = repro_torch.serve(exe, SchedulerOptions(
                buckets=BucketPolicy.default(
                    max_batch=SERVE_SMOKE["slots"],
                    max_len=SERVE_SMOKE["max_len"], min_len=8),
                **SERVE_SMOKE), sampler=rec, engine_worker="manual")
            sched.wait_warm()
            for r in reqs[:-SERVE_SMOKE_LATE]:
                sched.submit(r)
            sched.step()
            sched.step()
            for r in reqs[-SERVE_SMOKE_LATE:]:
                sched.submit(r)
            sched.run()
            runs[dev] = (dict(sched.generated), rec.rows, sched.summary(),
                         _replays_cover_steps(sched),
                         sched._pool.bytes if sched._pool else 0)
            sched.shutdown()
        toks, rows, summ, (captured, covered), pool = runs[DEVICE]
        problems += _engine_problems(f"serve {arch}", summ["engines"])
        same = toks == runs["cpu"][0]
        err = limit = 0.0
        for key, want in runs["cpu"][1].items():
            e, scale = _rel_err(rows[key], want)
            if e > err:
                err = e
            limit = max(limit, SERVE_SMOKE_TOL * scale)
            if e > SERVE_SMOKE_TOL * scale:
                problems.append(f"serve {arch} uid {key[0]} token {key[1]}:"
                                f" logits {e} > {SERVE_SMOKE_TOL * scale}")
        dec = summ["runtime"]["decode"]
        emit({"phase": "serve", "case": "smoke", "arch": arch,
              "tokens_equal": same, "max_abs_err": err, "limit": limit,
              "rows": len(rows), "decode_steps": summ["decode_steps"],
              "every_step_a_replay": captured and covered,
              "warm_buckets": dec["warm_buckets"],
              "bucket_hits": dec["bucket_hits"],
              "chunked_prefill": summ.get("chunked_prefill"),
              "prefix_cache": summ.get("prefix_cache"),
              "length_buckets": "prefill" in summ["runtime"],
              "engines": summ["engines"],
              "graph_pool_bytes": pool,
              "seconds": time.perf_counter() - t0})
        if not same or set(rows) != set(runs["cpu"][1]):
            problems.append(f"serve {arch}: card tokens {toks} against the "
                            f"CPU's {runs['cpu'][0]}")
        if not (captured and covered):
            problems.append(f"serve {arch}: a decode step was not a replay")
    return problems


def _whole_requests(np, cfg):
    """SERVE_WHOLE's requests from seed 0, each with its family's extra
    input."""
    from repro_torch.serve import Request
    lengths, new = SERVE_WHOLE
    rng = np.random.default_rng(0)
    reqs = []
    for uid, n in enumerate(lengths):
        inputs = None
        if cfg.family == "audio":
            inputs = {"frames": rng.standard_normal(
                (cfg.n_frames, cfg.d_model)).astype(np.float32)}
        if cfg.family == "vlm":
            inputs = {"patches": rng.standard_normal(
                (cfg.num_image_tokens, cfg.vit_dim)).astype(np.float32)}
        reqs.append(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab, n).astype(np.int32), max_new_tokens=new,
            inputs=inputs))
    return reqs


def phase_serve_whole(torch, np):
    """(e) Each SMOKE config at f32 served on the card and on the CPU with
    neither chunks nor length buckets: one whole-prompt program a prompt
    length, captured on the card at its first admission (several slots
    admitted in one step).  Tokens equal, every logits row within
    SERVE_SMOKE_TOL x max(1, max|logits|), ``whole_prefill`` captured
    with one program a distinct prompt length, and the longest
    program's replay bit-equal to ``model.prefill`` run eagerly on a
    zeroed clone of its cache."""
    import dataclasses
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve import SchedulerOptions
    problems = []
    for arch in ENGINE_ARCHS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32")
        params = get_model(cfg).init(0, "cpu")
        reqs = _whole_requests(np, cfg)
        lengths = {len(r.prompt) for r in reqs}
        runs = {}
        for dev in ("cpu", DEVICE):
            exe = repro_torch.compile(cfg, repro_torch.CompileOptions(
                target="engine", device=dev), params=params)
            rec = _Recorder()
            sched = repro_torch.serve(exe, SchedulerOptions(
                slots=SERVE_SMOKE["slots"], max_len=SERVE_SMOKE["max_len"]),
                sampler=rec)
            for r in reqs:
                sched.submit(r)
            sched.run()
            runs[dev] = (dict(sched.generated), rec.rows, sched.summary())
        toks, rows, summ = runs[DEVICE]
        whole = summ["engines"].get("whole_prefill")
        prog = sched.whole_prefill_programs()[-1]
        req = next(r for r in reqs if len(r.prompt) == prog.length)
        with torch.inference_mode():
            batch = sched._prefill_batch(req.prompt[None], req.inputs, "cpu")
            got, cache = prog(batch)
            got_cache = {k: v.clone() for k, v in cache.items()}
            fresh = {k: torch.zeros_like(v) for k, v in cache.items()}
            want, fresh = prog.model.prefill(prog.params, {
                k: v.to(DEVICE) for k, v in batch.items()}, fresh)
        equal = torch.equal(got, want[:, -1:]) and all(
            torch.equal(got_cache[k], fresh[k]) for k in fresh)
        err = limit = 0.0
        for key, want_row in runs["cpu"][1].items():
            e, scale = _rel_err(rows[key], want_row)
            err, limit = max(err, e), max(limit, SERVE_SMOKE_TOL * scale)
        same = toks == runs["cpu"][0] and set(rows) == set(runs["cpu"][1])
        emit({"phase": "serve", "case": "whole_prefill", "arch": arch,
              "tokens_equal": same, "max_abs_err": err, "limit": limit,
              "prompt_lengths": sorted(lengths), "whole_prefill": whole,
              "replay_bit_equal": equal, "replayed_length": prog.length,
              "pool_bytes": sched._whole_pool.bytes
              if sched._whole_pool else 0,
              "program_pool_bytes": [
                  p.pool_bytes for p in sched.whole_prefill_programs()],
              "seconds": time.perf_counter() - t0})
        if not (same and err <= limit and equal and whole == {
                "captured": True, "programs": len(lengths)}):
            problems.append(
                f"serve whole_prefill {arch}: tokens equal {same}, logits "
                f"err {err} (limit {limit}), replay bit-equal {equal}, "
                f"whole_prefill {whole} for {len(lengths)} lengths")
        sched.shutdown()
        del sched, exe, prog, cache, got_cache, fresh
    return problems


def _qwen_requests(np, cfg, spec=SERVE_QWEN_REQUESTS):
    """``spec`` (SERVE_QWEN_REQUESTS's fields) from seed 0: the sharers'
    prompts are the head and a tail of at least one token, the others
    are drawn whole."""
    from repro_torch.serve import Request
    n, (lo, hi), sharers, head_len, new = spec
    rng = np.random.default_rng(0)
    head = rng.integers(0, cfg.vocab, head_len).astype(np.int32)
    share = set(rng.choice(n, sharers, replace=False).tolist())
    reqs = []
    for uid in range(n):
        plen = int(rng.integers(head_len + 1 if uid in share else lo,
                                hi + 1))
        p = rng.integers(0, cfg.vocab, plen).astype(np.int32)
        if uid in share:
            p[:head_len] = head
        reqs.append(Request(uid=uid, prompt=p, max_new_tokens=new))
    return reqs, sorted(share)


#: The functions of ``models/common.py`` whose outputs the step probe
#: records, in call order, to find where two steps' rows first part.
STEP_PROBE_OPS = ("rms_norm", "col_parallel_in", "apply_rope",
                  "decode_attention_jnp", "row_parallel_out", "silu",
                  "lm_logits")


def _step_probe(torch, sched):
    """Whole decode steps over the live cache, from one saved state: row
    0's logits of each bucket's captured step and of its eager step
    (``step_rows`` as the step sets it) against the full-slots step's;
    and the bare eager step (no ``step_rows``) at each bucket against
    the full-slots one, op by op (STEP_PROBE_OPS, row 0 of each output):
    the first op whose row 0 differs.  Also the probe buckets that were
    still cold when the serve run ended (returned second, sorted)."""
    from repro_torch.models import common as C
    from repro_torch.runtime import Bucket
    sm = sched.slot_manager
    # a bucket whose background capture failed (a device-wide sync during
    # it) and that no later batch asked for again stays cold: it is
    # recorded, then captured here, with no traffic beside it
    cold = sorted(b for b in PROBE_ROWS
                  if sched._decode_engine.peek(Bucket(b)) is None)
    sched._decode_engine.warm_up([Bucket(b) for b in PROBE_ROWS],
                                 block=True)
    steps = {b: sched._decode_engine.peek(Bucket(b))
             for b in sorted(PROBE_ROWS, reverse=True)}
    top = max(PROBE_ROWS)
    saved = {k: v.clone() for k, v in sm.cache.items()}
    tokens = steps[top].tokens

    def restore():
        for k, v in sm.cache.items():
            v.copy_(saved[k])

    def recorded(b):
        trace, real = [], {n: getattr(C, n) for n in STEP_PROBE_OPS}

        def wrap(name, fn):
            def inner(*a, **kw):
                out = fn(*a, **kw)
                first = out[0] if isinstance(out, list) else out
                trace.append((name, first[:1].float().cpu()))
                return out
            return inner
        try:
            for n, fn in real.items():
                setattr(C, n, wrap(n, fn))
            restore()
            logits = sched.model.decode_step(sched.params, sm.rows(b),
                                             tokens[:b])[0][:1].float().cpu()
        finally:
            for n, fn in real.items():
                setattr(C, n, fn)
        return logits, trace

    out = {}
    with torch.inference_mode():
        row0 = {}
        for b, step in steps.items():
            restore()
            captured = step()[:1].float().cpu()
            restore()
            eager = step.eager()[:1].float().cpu()
            row0[b] = (captured, eager)
        bare = {b: recorded(b) for b in steps}
        restore()
    for b in steps:
        first = None
        for i, ((name, x), (_, y)) in enumerate(zip(bare[b][1],
                                                   bare[top][1])):
            if not torch.equal(x, y):
                first = {"op": name, "call": i,
                         "max_abs_diff": float((x - y).abs().max())}
                break
        out[b] = {
            "captured_vs_full": float((row0[b][0] - row0[top][0])
                                      .abs().max()),
            "eager_vs_full": float((row0[b][1] - row0[top][1]).abs().max()),
            "captured_vs_eager": float((row0[b][0] - row0[b][1])
                                       .abs().max()),
            "bare_eager_vs_full": float((bare[b][0] - bare[top][0])
                                        .abs().max()),
            "bare_first_difference": first}
    del saved
    return out, cold


def _tensor_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


#: Row counts of the row-independence probe, each against the largest.
PROBE_ROWS = (1, 2, 4, 8)
#: The probe's ops that the decode step runs under ``step_rows`` (padded
#: to the full slot count); it runs the rest bare.
STEP_ROWS_OPS = ("head_f32", "rms_norm", "rms_norm_f32")


def _row_probe(torch, cfg, params):
    """Each decode product of qwen2.5-14b's layer 0 (bf16: q/k/v, the
    attention's output, the MLP's gate/up/down, through
    ``models/common.py``'s ``col_parallel_in``/``row_parallel_out``), its
    f32 head (``lm_logits``) and an RMS norm, at M = PROBE_ROWS rows of
    seeded inputs: each row's max |difference| from the same row at the
    largest M, bare and under ``step_rows`` (the decode step pads the
    norms and the head, and runs the products bare)."""
    from repro_torch.models import common as C
    lp = C.layer_views(params["layers"], 1)[0]
    attn, ffn = lp["attn"], lp["ffn"]
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    top = max(PROBE_ROWS)

    def x(width):
        return torch.randn((top, 1, width), generator=gen, device=DEVICE,
                           dtype=torch.float32).to(torch.bfloat16)

    d = cfg.d_model
    attn_in, ffn_in = x(attn["wo"].shape[0]), x(ffn["wo"].shape[0])
    xd = x(d)
    ops = {
        "wq": (lambda a: C.col_parallel_in(a, (attn["wq"],))[0], xd),
        "wk": (lambda a: C.col_parallel_in(a, (attn["wk"],))[0], xd),
        "wv": (lambda a: C.col_parallel_in(a, (attn["wv"],))[0], xd),
        "attn_wo": (lambda a: C.row_parallel_out(a, attn["wo"]), attn_in),
        "wi_gate": (lambda a: C.col_parallel_in(a, (ffn["wi_gate"],))[0],
                    xd),
        "wi_up": (lambda a: C.col_parallel_in(a, (ffn["wi_up"],))[0], xd),
        "mlp_wo": (lambda a: C.row_parallel_out(a, ffn["wo"]), ffn_in),
        "head_f32": (lambda a: C.lm_logits(a, head), xd),
        "rms_norm": (lambda a: C.rms_norm(a, lp["ln1"], cfg.norm_eps), xd),
        # The FFN's norm takes the residual sum in f32 (_ffn_block): its
        # squares are not exact, so the order of the sum shows.
        "rms_norm_f32": (lambda a: C.rms_norm(a, lp["ln2"], cfg.norm_eps),
                         xd.float() + x(d).float()),
    }
    out = {}
    with torch.inference_mode():
        for name, (fn, inp) in ops.items():
            row = {}
            for padded in (False, True):
                with C.step_rows(top if padded else 0):
                    want = fn(inp).float()
                    diffs = {}
                    for m in PROBE_ROWS:
                        got = fn(inp[:m].contiguous()).float()
                        diffs[m] = float((got - want[:m]).abs().max())
                row["padded" if padded else "bare"] = diffs
            out[name] = row
    return out


def phase_serve_qwen(torch, np):
    """(b) qwen2.5-14b whole at bf16 (made on the card) served through
    ``repro_torch.serve(exe, ...)`` with ``fold=True``: throughput, TTFT,
    captured against eager step time, launches and busy share of one
    replay, bucket and prefix counters, peak memory; one captured step
    bit-equal to eager ``decode_step`` on a clone of the cache; no buffer
    moved and no byte allocated over steady-state steps; then the same
    requests at a fixed shape (one full-slots step), tokens compared."""
    import gc
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves
    from repro_torch.runtime import Bucket, BucketPolicy
    from repro_torch.serve import Request, Scheduler, SchedulerOptions
    problems = []
    cfg = get_config("qwen2.5-14b")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    exe = repro_torch.compile(cfg, repro_torch.CompileOptions(
        target="engine", precision="bf16", device=DEVICE), init_seed=0)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    compile_peak = _peak_gb(torch)
    torch.cuda.reset_peak_memory_stats()
    weights = torch.cuda.memory_allocated()
    opts = SchedulerOptions(buckets=BucketPolicy.default(
        max_batch=SERVE_QWEN["slots"], max_len=SERVE_QWEN["max_len"]),
        **SERVE_QWEN)
    t0 = time.perf_counter()
    sched = repro_torch.serve(exe, opts)
    build_s = time.perf_counter() - t0
    probe = _row_probe(torch, cfg, sched.params)
    emit({"phase": "serve", "case": "qwen2.5-14b", "op": "row_probe",
          "rows": list(PROBE_ROWS), "max_abs_diff_vs_largest": probe})
    unequal = [n for n, r in probe.items() if any(r[
        "padded" if n in STEP_ROWS_OPS else "bare"].values())]
    if unequal:
        problems.append(f"serve qwen: as the decode step runs them, the "
                        f"rows of {unequal} depend on the row count")
    held = {id(t) for t in tree_leaves(exe.params)}
    fold_bytes = _tensor_bytes(t for t in tree_leaves(sched.params)
                               if id(t) not in held)
    reqs, share = _qwen_requests(np, cfg)
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run()
    serve_s = time.perf_counter() - t0
    served = {u: list(t) for u, t in sched.generated.items()}
    summ = sched.summary()
    warm = sched.wait_warm(300.0)
    captured, covered = _replays_cover_steps(sched)
    dec = summ["runtime"]["decode"]
    prog = sched._chunk_engine.peek(Bucket(1, SERVE_QWEN["prefill_chunk"]))
    chunks_replayed = prog.captured and prog.calls == summ["prefill_chunks"]
    row = {"phase": "serve", "case": "qwen2.5-14b", "op": "serve",
           "precision": "bf16", "params": exe.cost_summary()["params"],
           "requests": len(reqs), "prompt_tokens": int(sum(
               len(r.prompt) for r in reqs)), "sharers": share,
           "options": {k: str(v) for k, v in opts.to_dict().items()},
           "compile_s": compile_s, "build_s": build_s, "serve_s": serve_s,
           "tokens_per_s": summ["tokens_per_s"],
           "total_new_tokens": summ["total_new_tokens"],
           "ttft_p50_ms": summ["ttft_p50"] * 1e3,
           "ttft_p99_ms": summ["ttft_p99"] * 1e3,
           "decode_steps": summ["decode_steps"],
           "mean_batch_occupancy": summ["mean_batch_occupancy"],
           "prefill_chunks": summ["prefill_chunks"],
           "decode_buckets": {k: dec[k] for k in (
               "bucket_hits", "bucket_misses", "fallback_serves",
               "background_compiles", "compile_stalls", "warm_buckets",
               "compile_ms")},
           "chunk_stalls": summ["runtime"]["chunk"]["compile_stalls"],
           "prefix_cache": summ["prefix_cache"],
           "engines": summ["engines"],
           "every_step_a_replay": captured and covered,
           "every_chunk_a_replay": chunks_replayed,
           "chunk_capture_s": prog.capture_s,
           "chunk_capture_reserved_gb": prog.pool_bytes / 1e9,
           "graph_pool_gb": sched._pool.bytes / 1e9 if sched._pool else 0.0,
           "all_buckets_warm": warm,
           # Growth of memory_reserved over each capture; a capture in
           # the background also counts what the serving thread took
           # meanwhile, so only the full-slots one (at build) is the pool's.
           "capture_reserved_gb": {str(s.batch): s.pool_bytes / 1e9
                                   for s in sched.decode_steps()},
           "capture_s": {str(s.batch): s.capture_s
                         for s in sched.decode_steps()},
           "fold_report": sched.fold_report,
           "weights_gb": weights / 1e9, "fold_gb": fold_bytes / 1e9,
           "cache_gb": _tensor_bytes(sched.slot_manager.cache.values()) / 1e9,
           "peak_gb": _peak_gb(torch), "compile_peak_gb": compile_peak}
    emit(row)
    if dec["compile_stalls"] or not (captured and covered) or not warm:
        problems.append(f"serve qwen: {dec['compile_stalls']} decode stalls,"
                        f" every step a replay {captured and covered}, "
                        f"buckets warm {warm}")
    if summ["completed"] != len(reqs) or not summ["prefix_cache"]["hits"]:
        problems.append(f"serve qwen: {summ['completed']} completed, prefix "
                        f"cache {summ['prefix_cache']}")
    problems += _engine_problems("serve qwen", summ["engines"])
    if not chunks_replayed:
        problems.append(f"serve qwen: {prog.calls} chunk program calls for "
                        f"{summ['prefill_chunks']} chunks, captured "
                        f"{prog.captured}")

    probe, cold = _step_probe(torch, sched)
    emit({"phase": "serve", "case": "qwen2.5-14b", "op": "step_probe",
          "row0_max_abs_diff": probe, "cold_after_serve": cold,
          "cold_after_serve_count": len(cold)})
    if any(r["captured_vs_full"] for r in probe.values()):
        problems.append(f"serve qwen: a bucket's captured step gives row 0 "
                        f"other logits than the full-slots step: {probe}")

    # One step of each bucket captured against eager, in turns, and one
    # replay under the profiler.
    sm = sched.slot_manager
    for b in (1, SERVE_QWEN["slots"]):
        step = sched._decode_engine.peek(Bucket(b))
        turns = [host_median_ms(f, runs=SERVE_TIMED_RUNS, warmup=2)
                 for f in (step, step.eager, step.eager, step)]
        prof = device_profile(step, iters=3)
        dev_ms = sum(ms for _, ms in prof.values())
        launches = sum(n for n, _ in prof.values())
        top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:6]
        emit({"phase": "serve", "case": "qwen2.5-14b", "op": "decode_step",
              "batch": b, "captured_ms": [turns[0], turns[3]],
              "eager_ms": [turns[1], turns[2]], "device_ms": dev_ms,
              "replay_launches": launches,
              "busy_share": dev_ms / min(turns[0], turns[3]),
              "tokens_per_s": b / min(turns[0], turns[3]) * 1e3,
              "top_ops": [{"name": k[:100], "launches": n, "ms": ms}
                          for k, (n, ms) in top]})

    problems += _chunk_rows(torch, np, exe, sched, prog, summ)

    # The full-slots replay against eager decode_step on a clone of the
    # cache, sliced the same way (the same strides).
    step = sched._decode_engine.peek(Bucket(SERVE_QWEN["slots"]))
    with torch.inference_mode():
        clone = {k: v.clone() for k, v in sm.cache.items()}
        want = exe.model.decode_step(
            sched.params, sm.rows(step.batch, clone), step.tokens)[0].clone()
        got = step().clone()
        torch.cuda.synchronize()
        logits_equal = torch.equal(got, want)
        cache_equal = all(torch.equal(sm.cache[k], clone[k]) for k in clone)
    del clone, want, got

    # Steady state: 8 requests in flight, no admission, no retirement.
    new = SERVE_STEADY_STEPS + 4
    rng = np.random.default_rng(1)
    for i in range(SERVE_QWEN["slots"]):
        sched.submit(Request(uid=1000 + i, max_new_tokens=new,
                             prompt=rng.integers(
                                 0, cfg.vocab, SERVE_STEADY_PROMPT).astype(
                                 np.int32)))
    sched.step()
    sched.step()
    ptrs = sm.buffer_pointers()
    torch.cuda.current_stream().synchronize()
    allocated = torch.cuda.memory_allocated()
    moved, step_ms = 0, []
    for _ in range(SERVE_STEADY_STEPS):
        t = time.perf_counter()
        sched.step()
        step_ms.append((time.perf_counter() - t) * 1e3)
        moved += sm.buffer_pointers() != ptrs
    torch.cuda.current_stream().synchronize()
    grew = torch.cuda.memory_allocated() - allocated
    active = sched.num_active()
    sched.run()
    emit({"phase": "serve", "case": "qwen2.5-14b", "op": "steady_state",
          "replay_logits_equal": logits_equal,
          "replay_cache_equal": cache_equal, "active": active,
          "steps": SERVE_STEADY_STEPS, "steps_moving_a_buffer": moved,
          "allocated_growth_bytes": grew, "scheduler_step_ms": step_ms})
    if not (logits_equal and cache_equal):
        problems.append(f"serve qwen: replay vs eager on a clone: logits "
                        f"equal {logits_equal}, cache equal {cache_equal}")
    if moved or grew or active != SERVE_QWEN["slots"]:
        problems.append(f"serve qwen steady state: {moved} steps moved a "
                        f"buffer, {grew} bytes allocated, {active} active")

    # The same requests at a fixed shape: one full-slots step.
    params = sched.params
    sched.shutdown()
    del sched, sm, step, prog
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fixed = Scheduler(exe.model, params, SchedulerOptions(
        fold=False, **SERVE_QWEN))
    for r in reqs:
        fixed.submit(r)
    fixed.run()
    agree, first_diff = 0, {}
    for uid, toks in served.items():
        other = fixed.generated[uid]
        if toks == other:
            agree += 1
        else:
            first_diff[uid] = next(i for i, (x, y) in enumerate(
                zip(toks, other)) if x != y)
    emit({"phase": "serve", "case": "qwen2.5-14b", "op": "fixed_shape",
          "requests_equal": agree, "requests": len(served),
          "first_difference": first_diff,
          "tokens_per_s": fixed.summary()["tokens_per_s"],
          "seconds": time.perf_counter() - t0, "peak_gb": _peak_gb(torch)})
    if agree != len(served):
        problems.append(f"serve qwen: bucketed and fixed-shape tokens differ "
                        f"for {len(served) - agree} of {len(served)} "
                        f"requests (first differences {first_diff})")
    fixed.shutdown()
    del fixed, params, exe
    gc.collect()
    torch.cuda.empty_cache()
    return problems


def _chunk_rows(torch, np, exe, sched, prog, summ):
    """One 256-token qwen2.5-14b chunk at start 0, run eagerly with host
    ints (the scheduler's path before the chunk program) and through the
    scheduler's captured chunk program (staging a request's cache), in
    turns: host ms, device ms, launches, busy share, the bound; then the
    program against the eager chunk on a clone of the request's cache,
    at two starts (the second attends the first's rows), bit for bit."""
    from repro_torch.models.common import tree_leaves
    chunk, max_len = SERVE_QWEN["prefill_chunk"], SERVE_QWEN["max_len"]
    cfg, params, problems = exe.cfg, sched.params, []
    host = np.random.default_rng(2).integers(0, cfg.vocab, (1, chunk)) \
        .astype(np.int32)
    with torch.inference_mode():
        one = exe.model.init_cache(1, max_len, DEVICE)
        toks = torch.as_tensor(host, device=DEVICE)
        runs = {"eager": lambda: exe.model.prefill_chunk(params, toks, one,
                                                         0, chunk),
                "captured": lambda: prog(host, one, 0, chunk)}
        turns = [host_median_ms(runs[k], runs=SERVE_TIMED_RUNS, warmup=2)
                 for k in ("captured", "eager", "eager", "captured")]
        profs = {k: device_profile(f, iters=3) for k, f in runs.items()}
    mm, att = _prefill_flops(cfg, params, 1, chunk)
    wbytes = _tensor_bytes(tree_leaves(params))
    t_bytes = (wbytes + _cache_bytes(one, chunk, 1)) / HBM_BYTES_PER_S * 1e3
    t_ops = (mm / BF16_FLOPS_PER_S + att / F32_FLOPS_PER_S) * 1e3
    staged_in = _tensor_bytes(one.values())
    staged_out = sum(t.numel() * t.element_size() * (
        chunk / t.shape[d] if d is not None else 1) for t, d in (
            (one[k], prog.seq_dims.get(k)) for k in one))
    for mode, ms in (("eager", turns[1:3]), ("captured", (turns[0],
                                                          turns[3]))):
        prof = profs[mode]
        dev_ms = sum(v[1] for v in prof.values())
        row = {"phase": "serve", "case": "qwen2.5-14b",
               "op": "prefill_chunk" if mode == "eager"
               else "prefill_chunk_captured", "tokens": chunk, "start": 0,
               "ms": min(ms), "ms_turns": list(ms), "device_ms": dev_ms,
               "launches": sum(v[0] for v in prof.values()),
               "busy_share": dev_ms / min(ms),
               "captured": mode == "captured" and prog.captured,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "chunks_served": summ["prefill_chunks"]}
        if mode == "captured":
            row["staging_device_ms"] = sum(
                v[1] for k, v in prof.items() if k.startswith("Memcpy DtoD"))
            row["staging_bytes"] = {"in": staged_in, "out": staged_out}
            row["capture_s"] = prog.capture_s
        emit(row)
    equal = []
    with torch.inference_mode():
        req = exe.model.init_cache(1, max_len, DEVICE)
        for start in (0, chunk):
            clone = {k: v.clone() for k, v in req.items()}
            want = exe.model.prefill_chunk(params, toks, clone, start,
                                           chunk)[0].clone()
            got, _ = prog(host, req, start, chunk)
            torch.cuda.current_stream().synchronize()
            equal.append({"start": start,
                          "logits_equal": torch.equal(got, want),
                          "cache_equal": all(torch.equal(req[k], clone[k])
                                             for k in req)})
        del req, clone, want, got
    emit({"phase": "serve", "case": "qwen2.5-14b",
          "op": "prefill_chunk_replay_vs_eager", "checks": equal})
    if not all(e["logits_equal"] and e["cache_equal"] for e in equal):
        problems.append(f"serve qwen: the chunk program's replay against "
                        f"the eager chunk on a clone: {equal}")
    del one, toks, runs
    return problems


def phase_serve_whisper(torch, np):
    """(d) whisper-base whole at f32 through the length buckets'
    padded-prefill programs (every bucket captured first), on the card
    and on the CPU over the same weights: the tokens equal, each logits
    row within ENGINE_DECODE_TOL x max(1, max|logits|), every prefill a
    call of a captured program; then one bucket's replay against its
    eager call on the same inputs, bit for bit, in turns: host ms, device
    ms, launches, busy share."""
    import dataclasses
    import gc
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.runtime import BucketPolicy
    from repro_torch.serve import Request, SchedulerOptions
    problems = []
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("whisper-base"), dtype="float32")
    params = get_model(cfg).init(0, "cpu")
    n, (lo, hi), new = SERVE_WHISPER_REQUESTS
    rng = np.random.default_rng(0)
    reqs = [Request(uid=u, max_new_tokens=new,
                    prompt=rng.integers(0, cfg.vocab, int(rng.integers(
                        lo, hi + 1))).astype(np.int32),
                    inputs={"frames": rng.standard_normal(
                        (cfg.n_frames, cfg.d_model)).astype(np.float32)})
            for u in range(n)]
    runs, timing = {}, {}
    for dev in (DEVICE, "cpu"):
        t1 = time.perf_counter()
        exe = repro_torch.compile(cfg, repro_torch.CompileOptions(
            target="engine", device=dev), params=params)
        rec = _Recorder()
        sched = repro_torch.serve(exe, SchedulerOptions(
            buckets=BucketPolicy.default(
                max_batch=SERVE_WHISPER["slots"],
                max_len=SERVE_WHISPER["max_len"]),
            **SERVE_WHISPER), sampler=rec, engine_worker="manual")
        sched.wait_warm()
        warm_s = time.perf_counter() - t1
        for r in reqs:
            sched.submit(r)
        t1 = time.perf_counter()
        sched.run()
        serve_s = time.perf_counter() - t1
        summ = sched.summary()
        eng = sched._prefill_engine
        progs = [eng.peek(b) for b in eng.warm_buckets()] if eng else []
        runs[dev] = (dict(sched.generated), rec.rows, summ, {
            "warm_s": warm_s, "serve_s": serve_s,
            "prefill_calls": sum(p.calls for p in progs),
            "programs_captured": [p.captured for p in progs]})
        if dev == DEVICE and progs:
            timing = _prefill_program_rows(torch, np, cfg, sched, progs,
                                           reqs[0])
            runs[dev][3]["pool_gb"] = (sched._pool.bytes / 1e9
                                       if sched._pool else 0.0)
            runs[dev][3]["capture_s"] = {p.bucket: p.capture_s
                                         for p in progs}
            runs[dev][3]["peak_gb"] = _peak_gb(torch)
        sched.shutdown()
        del sched, exe, progs, eng
        gc.collect()
    toks, rows, summ, info = runs[DEVICE]
    err = limit = 0.0
    for key, want in runs["cpu"][1].items():
        e, scale = _rel_err(rows[key], want)
        err, limit = max(err, e), max(limit, ENGINE_DECODE_TOL * scale)
        if e > ENGINE_DECODE_TOL * scale:
            problems.append(f"serve whisper uid {key[0]} token {key[1]}: "
                            f"{e} > {ENGINE_DECODE_TOL * scale}")
    same = toks == runs["cpu"][0]
    emit({"phase": "serve", "case": "whisper-base", "op": "served_vs_cpu",
          "requests": n, "prompt_tokens": [len(r.prompt) for r in reqs],
          "new_tokens": new, "tokens_equal": same, "max_abs_err": err,
          "limit": limit, "engines": summ["engines"],
          "engines_cpu": runs["cpu"][2]["engines"],
          "prefill_buckets": summ["runtime"]["prefill"]["warm_buckets"],
          "prefill_bucket_hits": summ["runtime"]["prefill"]["bucket_hits"],
          "prefill_stalls": summ["runtime"]["prefill"]["compile_stalls"],
          "tokens_per_s": summ["tokens_per_s"],
          "ttft_p50_ms": summ["ttft_p50"] * 1e3,
          "ttft_p99_ms": summ["ttft_p99"] * 1e3, **info,
          "cpu": runs["cpu"][3], "seconds": time.perf_counter() - t0})
    problems += _engine_problems("serve whisper", summ["engines"])
    if not same or set(rows) != set(runs["cpu"][1]) \
            or "prefill" not in summ["engines"] \
            or info["prefill_calls"] != n or not timing.get("equal"):
        problems.append(f"serve whisper: tokens equal {same}, engines "
                        f"{summ['engines']}, {info['prefill_calls']} program "
                        f"calls for {n} requests, replay equal "
                        f"{timing.get('equal')}")
    return problems


def _prefill_program_rows(torch, np, cfg, sched, progs, req):
    """The first request's bucket's program: a call (copy in, replay)
    and its eager call over the same static inputs, in turns; the two
    logits and caches bit for bit."""
    from repro_torch.runtime import Bucket
    plen = len(req.prompt)
    bucket = sched._prefill_engine.policy.bucket_for(1, plen)
    prog = sched._prefill_engine.peek(Bucket(1, bucket.length))
    padded = np.zeros((1, bucket.length), np.int32)
    padded[0, :plen] = req.prompt
    batch = sched._prefill_batch(padded, req.inputs, "cpu")
    with torch.inference_mode():
        got, cache = prog(batch, plen)
        got_cache = {k: v.clone() for k, v in cache.items()}
        want = prog.eager().clone()
        torch.cuda.current_stream().synchronize()
        equal = torch.equal(got, want) and all(
            torch.equal(got_cache[k], cache[k]) for k in cache)
        runs = {"captured": lambda: prog(batch, plen), "eager": prog.eager}
        turns = [host_median_ms(runs[k], runs=SERVE_TIMED_RUNS, warmup=2)
                 for k in ("captured", "eager", "eager", "captured")]
        profs = {k: device_profile(f, iters=3) for k, f in runs.items()}
    out = {"equal": equal}
    for mode, ms in (("captured", (turns[0], turns[3])),
                     ("eager", turns[1:3])):
        dev_ms = sum(v[1] for v in profs[mode].values())
        emit({"phase": "serve", "case": "whisper-base",
              "op": "prefill_program", "mode": mode,
              "bucket": bucket.length, "length": plen, "ms": min(ms),
              "ms_turns": list(ms), "device_ms": dev_ms,
              "launches": sum(v[0] for v in profs[mode].values()),
              "busy_share": dev_ms / min(ms),
              "captured": mode == "captured" and prog.captured,
              "replay_equal_eager": equal,
              "pool_bytes": prog.pool_bytes if mode == "captured" else 0})
    return out


def phase_serve_mamba(torch, np):
    """(c) mamba2-780m whole at f32, served: prompts of 300 tokens cross a
    padded 256-token SSD chunk; chunking and length buckets switch
    themselves off (the state does not grow with max_len).  Each
    generated position's served logits within ENGINE_DECODE_TOL of the
    forward's over the prompt plus the served tokens, and the tokens
    its argmax."""
    import dataclasses
    import gc
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.runtime import Bucket, BucketPolicy
    from repro_torch.serve import Request, SchedulerOptions
    problems = []
    n, plen, new = SERVE_MAMBA
    cfg = dataclasses.replace(get_config("mamba2-780m"), dtype="float32")
    t0 = time.perf_counter()
    exe = repro_torch.compile(cfg, repro_torch.CompileOptions(
        target="engine", device=DEVICE), init_seed=0)
    rec = _Recorder()
    sched = repro_torch.serve(exe, SchedulerOptions(
        buckets=BucketPolicy.default(max_batch=SERVE_MAMBA_OPTS["slots"],
                                     max_len=SERVE_MAMBA_OPTS["max_len"]),
        **SERVE_MAMBA_OPTS), sampler=rec)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (n, plen)).astype(np.int32)
    for uid in range(n):
        sched.submit(Request(uid=uid, prompt=prompts[uid],
                             max_new_tokens=new))
    sched.run()
    summ = sched.summary()
    sched.wait_warm(120.0)
    captured, covered = _replays_cover_steps(sched)
    step = sched._decode_engine.peek(Bucket(SERVE_MAMBA_OPTS["slots"]))
    turns = [host_median_ms(f, runs=SERVE_TIMED_RUNS, warmup=2)
             for f in (step, step.eager, step.eager, step)]
    dev_ms = sum(ms for _, ms in device_profile(step, iters=3).values())
    served = np.array([sched.generated[u] for u in range(n)], np.int32)
    with torch.inference_mode():
        full = exe(tokens=np.concatenate([prompts, served[:, :-1]], 1))[
            "logits"][:, plen - 1:]
    err, limit, same = 0.0, 0.0, True
    for uid in range(n):
        for i in range(new):
            e, scale = _rel_err(rec.rows[(uid, i)], full[uid, i:i + 1])
            err, limit = max(err, e), max(limit, ENGINE_DECODE_TOL * scale)
            if e > ENGINE_DECODE_TOL * scale:
                problems.append(f"serve mamba2 uid {uid} token {i}: {e} > "
                                f"{ENGINE_DECODE_TOL * scale}")
        same &= served[uid].tolist() == full[uid].argmax(-1).tolist()
    emit({"phase": "serve", "case": "mamba2-780m", "op": "served_vs_forward",
          "requests": n, "prompt": plen, "new_tokens": new,
          "ssd_chunk": cfg.ssm_chunk, "max_abs_err": err, "limit": limit,
          "tokens_equal_forward_argmax": same,
          "chunked_prefill": summ["chunked_prefill"],
          "length_buckets": "prefill" in summ["runtime"],
          "every_step_a_replay": captured and covered,
          "decode_steps": summ["decode_steps"],
          "tokens_per_s": summ["tokens_per_s"],
          "step_batch": step.batch, "captured_ms": [turns[0], turns[3]],
          "eager_ms": [turns[1], turns[2]], "device_ms": dev_ms,
          "seconds": time.perf_counter() - t0, "peak_gb": _peak_gb(torch)})
    if not same or not (captured and covered) \
            or summ["chunked_prefill"]["enabled"] \
            or "prefill" in summ["runtime"] or plen % cfg.ssm_chunk == 0:
        problems.append(f"serve mamba2: tokens equal {same}, every step a "
                        f"replay {captured and covered}, "
                        f"{summ['chunked_prefill']}")
    sched.shutdown()
    del sched, exe, full, step
    gc.collect()
    torch.cuda.empty_cache()
    return problems


def serve_main() -> int:
    """The serve phase, alone in this process so that it has the card's
    memory to itself (qwen2.5-14b's f32 init peaks near 59 GB)."""
    import torch
    import numpy as np
    if not torch.cuda.is_available():
        print("chip_smoke --serve: no CUDA device", file=sys.stderr)
        return 2
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("TF32 is on; the f32 comparisons need it off")
    t0 = time.perf_counter()
    problems = phase_serve_smoke(torch, np)
    problems += phase_serve_whole(torch, np)
    emit({"phase": "serve", "case": "smoke_done",
          "seconds": time.perf_counter() - t0})
    problems += phase_serve_qwen(torch, np)
    problems += phase_serve_whisper(torch, np)
    problems += phase_serve_mamba(torch, np)
    if problems:
        raise SystemExit("serve phase failed: " + "; ".join(problems))
    return 0


def phase_serve():
    """The serve phase in its child process."""
    return phase_child("--serve", SERVE_TIMEOUT_S, "serve")


# ---------------------------------------------------------------------------
# The shard phase (a child process: ``python3 chip_smoke.py --shard``)
# ---------------------------------------------------------------------------
#: (a) a single-device mesh against the unsharded captured program.
SHARD_BATCHES = (1, 256)
#: (b) two rank processes on the one card over gloo, each mesh in turn:
#: the models and precisions, f32's limit (relative to max(1, max|out|)),
#: and the calls timed per rank.
SHARD_MESHES = ("model=2", "data=2")
SHARD_MODELS = INT8_MODELS
SHARD_PRECISIONS = ("exact", "int8")
SHARD_F32_LIMIT = 1e-5
SHARD_TIMED_RUNS = 10
SHARD_RANK_TIMEOUT_S = 75
SHARD_TIMEOUT_S = 150
SHARD_DIR = os.path.join(ROOT, "build", "chip_smoke_shard")

SHARD_ROUND_TRIP = """
import json, sys
sys.path.insert(0, {src!r})
import numpy as np, torch
import repro_torch
torch.backends.cudnn.deterministic = True
exe = repro_torch.deserialize(open({blob!r}, "rb").read())
data = np.load({feeds!r})
out = exe(input=data["input"])
want = np.load({want!r})
summary = exe.cost_summary()
print(json.dumps({{"type": type(exe).__name__,
                  "reused": summary["sharding"]["reused"],
                  "captured": summary["programs"][256]["captured"],
                  "cache": {{k: v for k, v in exe.cache_info().items()
                            if k != "dir"}},
                  "equal": all(np.array_equal(v.cpu().numpy(), want[k])
                               for k, v in out.items())}}))
"""


def _shard_feeds(np, graph, batch, seed):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((batch,) + tuple(sp.shape)).astype(
        np.float32) for n, sp in graph.inputs.items()}


def _host_outputs(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


def shard_single_device(torch, np):
    """(a) ``mesh="data=1,model=1"`` on the ``cuda`` target: the six CNNs
    at exact (batch 1 and 256), C-HTWK, C-BH and VGG19 at int8, path B's
    decode graph at batch 8; each call a replay of a captured program,
    bit-equal to the unsharded captured program of the same options."""
    import repro_torch
    from repro_torch.core.program import CapturedProgram
    from repro_torch.table1_models import SUITE
    problems = []
    cases = [(n, "exact") for n in SUITE] + [(n, "int8") for n in INT8_MODELS]
    for name, prec in cases:
        g = SUITE[name]()
        opts = repro_torch.CompileOptions(target="cuda", precision=prec,
                                          device=DEVICE)
        base = repro_torch.compile(g, opts)
        exe = repro_torch.compile(g, opts.replace(mesh="data=1,model=1"))
        for b in sorted(SHARD_BATCHES, reverse=True):
            x = _shard_feeds(np, g, b, 40 + b)
            equal = outputs_equal(base(**x), exe(**x))
            replay = isinstance(exe.ensure_compiled(b), CapturedProgram)
            emit({"phase": "shard", "case": "single_device", "model": name,
                  "precision": prec, "batch": b, "bit_equal": equal,
                  "replay": replay})
            if not (equal and replay):
                problems.append(f"shard (a) {name} {prec} batch {b}: "
                                f"bit-equal {equal}, replay {replay}")
    g = decode_graph(repro_torch)
    opts = repro_torch.CompileOptions(target="cuda", device=DEVICE)
    base = repro_torch.compile(g, opts)
    exe = repro_torch.compile(g, opts.replace(mesh="data=1,model=1"))
    b = 8
    q, k, v, lens = decode_inputs(torch, b, DECODE["h"], DECODE["hkv"],
                                  DECODE["d"], DECODE["s"],
                                  DECODE_LENGTHS[b], 30 + b)
    feeds = {"q": q, "k": k, "v": v, "lengths": lens}
    equal = outputs_equal(base(**feeds), exe(**feeds))
    replay = isinstance(exe.ensure_compiled(b), CapturedProgram)
    emit({"phase": "shard", "case": "single_device", "model": "decode",
          "precision": "exact", "batch": b, "bit_equal": equal,
          "replay": replay})
    if not (equal and replay):
        problems.append(f"shard (a) decode batch {b}: bit-equal {equal}, "
                        f"replay {replay}")
    del base, exe, feeds, q, k, v
    torch.cuda.empty_cache()
    return problems


def shard_rank_main(rank: int, world: int, mesh: str, work: str) -> int:
    """One rank of (b): every model and precision on ``mesh``, against
    the parent's unsharded outputs in ``work``; one JSON row a case on
    stdout.  Every rank makes the same calls in the same order (the
    collectives pair up across ranks)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import repro_torch
    from repro_torch.table1_models import SUITE
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous",
                            rank=rank, world_size=world)
    want = np.load(os.path.join(work, "unsharded.npz"))
    try:
        for name in SHARD_MODELS:
            g = SUITE[name]()
            for prec in SHARD_PRECISIONS:
                exe = repro_torch.compile(g, repro_torch.CompileOptions(
                    target="cuda", precision=prec, device=DEVICE, mesh=mesh))
                summary = exe.cost_summary()["sharding"]
                for b in sorted(SHARD_BATCHES, reverse=True):
                    x = _shard_feeds(np, g, b, 40 + b)
                    out = _host_outputs(exe(**x))
                    key = f"{name} {prec} {b}"
                    ref = {k: want[f"{key} {k}"] for k in out}
                    err = max(float(np.abs(out[k] - ref[k]).max())
                              for k in out)
                    scale = max(1.0, max(float(np.abs(ref[k]).max())
                                         for k in out))
                    k_rows, i, _ = exe._data_split(b)
                    n = b // k_rows
                    rows = {k: want[f"{key} rows{k_rows}.{i} {k}"]
                            for k in out} if k_rows > 1 else ref
                    rows_equal = all(np.array_equal(
                        out[k][i * n:(i + 1) * n], rows[k]) for k in out)
                    # A rank's calls talk to the other rank, so both
                    # profile the same number of calls (profiled_call
                    # repeats until two profiles agree).
                    counts = {}
                    for _ in range(2):
                        _, c, _ = _profile_once(lambda: exe(**x))
                        counts = {k: max(v, counts.get(k, 0))
                                  for k, v in c.items()}
                    times = []
                    for _ in range(SHARD_TIMED_RUNS):
                        t = time.perf_counter()
                        exe(**x)
                        torch.cuda.synchronize()
                        times.append((time.perf_counter() - t) * 1e3)
                    print(json.dumps({
                        "phase": "shard", "case": "rank", "mesh": mesh,
                        "rank": rank, "coords": summary["coords"],
                        "model": name, "precision": prec, "batch": b,
                        "max_abs_err": err, "limit": SHARD_F32_LIMIT * scale,
                        "bit_equal": err == 0.0, "rows_split": k_rows,
                        "rows_bit_equal": rows_equal,
                        "launches": {"fused_matmul": counts["fused_matmul"],
                                     "fused_matmul_q8":
                                         counts["fused_matmul_q8"]},
                        "host_ms": statistics.median(times),
                        "captured": summary["captured"],
                        "staged_through_host":
                            summary["staged_through_host"],
                        "collectives": summary["collectives"]["counts"],
                        "sliced_params": len(summary["sliced_params"])}),
                        flush=True)
    finally:
        from repro_torch.dist.collectives import destroy_process_group
        destroy_process_group()
    return 0


def shard_two_ranks(torch, np):
    """(b) two rank processes on the one card over gloo, ``model=2`` and
    then ``data=2``: C-HTWK, C-BH and VGG19 at exact and int8, batch 1
    and 256, against the unsharded program run here."""
    import shutil
    import threading
    import repro_torch
    from repro_torch.table1_models import SUITE
    problems = []
    want, host_ms = {}, {}
    for name in SHARD_MODELS:
        g = SUITE[name]()
        for prec in SHARD_PRECISIONS:
            exe = repro_torch.compile(g, repro_torch.CompileOptions(
                target="cuda", precision=prec, device=DEVICE))
            for b in sorted(SHARD_BATCHES, reverse=True):
                x = _shard_feeds(np, g, b, 40 + b)
                key = f"{name} {prec} {b}"
                for k, v in _host_outputs(exe(**x)).items():
                    want[f"{key} {k}"] = v
                if b % 2 == 0:
                    for i in range(2):
                        part = {n: a[i * b // 2:(i + 1) * b // 2]
                                for n, a in x.items()}
                        for k, v in _host_outputs(exe(**part)).items():
                            want[f"{key} rows2.{i} {k}"] = v
                host_ms[key] = host_median_ms(lambda: exe(**x),
                                              runs=SHARD_TIMED_RUNS)
    for mesh in SHARD_MESHES:
        work = os.path.join(SHARD_DIR, mesh.replace("=", ""))
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        np.savez(os.path.join(work, "unsharded.npz"), **want)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--shard-rank",
             str(r), "2", mesh, work], cwd=ROOT, stdout=subprocess.PIPE,
            text=True) for r in range(2)]
        timers = [threading.Timer(SHARD_RANK_TIMEOUT_S, p.kill)
                  for p in procs]
        for t in timers:
            t.start()
        rows = []
        try:
            for p in procs:
                out, _ = p.communicate()
                rows += [json.loads(line) for line in out.splitlines()
                         if line.startswith("{")]
        finally:
            for t in timers:
                t.cancel()
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rcs = [p.returncode for p in procs]
        expected = 2 * len(SHARD_MODELS) * len(SHARD_PRECISIONS) \
            * len(SHARD_BATCHES)
        if rcs != [0, 0] or len(rows) != expected:
            problems.append(f"shard (b) {mesh}: ranks exited {rcs} with "
                            f"{len(rows)} of {expected} rows")
        for row in rows:
            key = f"{row['model']} {row['precision']} {row['batch']}"
            row["unsharded_host_ms"] = host_ms[key]
            emit(row)
            kernel = ("fused_matmul_q8" if row["precision"] == "int8"
                      else "fused_matmul")
            if mesh == "data=2":
                ok = row["rows_bit_equal"]
            elif row["precision"] == "int8":
                ok = row["bit_equal"]
            else:
                ok = row["max_abs_err"] <= row["limit"]
            if not ok or row["launches"][kernel] <= 0:
                problems.append(
                    f"shard (b) {mesh} rank {row['rank']} {key}: err "
                    f"{row['max_abs_err']} (limit {row['limit']}), rows "
                    f"bit-equal {row['rows_bit_equal']}, {kernel} "
                    f"launches {row['launches'][kernel]}")
        shutil.rmtree(work, ignore_errors=True)
    return problems


def shard_round_trip(torch, np):
    """(d) a ``"sharded"`` artifact in a fresh process on the card: the
    placement replayed, the executable cache hit, bit-equal; (e)
    ``MeshUnavailableError`` for ``data=2,model=2`` in one process."""
    import shutil
    import repro_torch
    from repro_torch.dist import MeshUnavailableError
    from repro_torch.table1_models import SUITE
    problems = []
    work = os.path.join(SHARD_DIR, "round_trip")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    g = SUITE["VGG19"]()
    exe = repro_torch.compile(g, repro_torch.CompileOptions(
        target="cuda", precision="int8", device=DEVICE,
        mesh="data=1,model=1", cache_dir=os.path.join(work, "cache")))
    x = _shard_feeds(np, g, 256, 7)
    np.savez(os.path.join(work, "want.npz"), **_host_outputs(exe(**x)))
    np.savez(os.path.join(work, "feeds.npz"), **x)
    with open(os.path.join(work, "exe.bin"), "wb") as f:
        f.write(exe.serialize())
    env = dict(os.environ, REPRO_TORCH_CACHE_DIR=os.path.join(work, "cache"))
    res = subprocess.run([sys.executable, "-c", SHARD_ROUND_TRIP.format(
        src=os.path.join(ROOT, "src"), blob=os.path.join(work, "exe.bin"),
        feeds=os.path.join(work, "feeds.npz"),
        want=os.path.join(work, "want.npz"))], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    try:
        got = json.loads(res.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        got = {"error": res.stderr[-2000:]}
    emit({"phase": "shard", "case": "round_trip", **got})
    if not (got.get("equal") and got.get("reused") and got.get("captured")
            and got.get("cache", {}).get("misses") == 0):
        problems.append(f"shard (d) round trip: {got}")
    try:
        repro_torch.compile(g, repro_torch.CompileOptions(
            target="cuda", device=DEVICE, mesh="data=2,model=2"))
        missing = None
    except MeshUnavailableError as e:
        missing = list(e.missing_axes)
    emit({"phase": "shard", "case": "mesh_unavailable",
          "mesh": "data=2,model=2", "missing_axes": missing})
    if missing != ["data", "model"]:
        problems.append(f"shard (e): missing axes {missing}")
    shutil.rmtree(work, ignore_errors=True)
    return problems


def shard_main() -> int:
    """The shard phase, in its own process: it starts rank processes
    that share the card."""
    import torch
    import numpy as np
    if not torch.cuda.is_available():
        print("chip_smoke --shard: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    problems = shard_single_device(torch, np)
    emit({"phase": "shard", "case": "single_device_done",
          "seconds": time.perf_counter() - t0})
    problems += shard_two_ranks(torch, np)
    problems += shard_round_trip(torch, np)
    if problems:
        raise SystemExit("shard phase failed: " + "; ".join(problems))
    return 0


def phase_shard():
    """The shard phase in its child process."""
    return phase_child("--shard", SHARD_TIMEOUT_S, "shard")


# ---------------------------------------------------------------------------
# The mesh phase (a child process: ``python3 chip_smoke.py --mesh``)
# ---------------------------------------------------------------------------
#: (m1) qwen2.5-14b whole at bf16 on ``data=2``, two ranks on the card:
#: the options, the batch buckets, and the requests (count, prompt
#: lengths, sharers of a head, its length, new tokens).  Buckets 4 and 8
#: give each rank one captured step (its 4 rows, or none of them): every
#: capture holds an f32 copy of the head (3.1 GB), and a rank must fit
#: MESH_MEMORY_SHARE of the card.
MESH_QWEN = dict(slots=8, max_len=1024, prefill_chunk=256, prefix_cache=4,
                 fold=False)
MESH_QWEN_BUCKETS = (4, 8)
MESH_QWEN_REQUESTS = (16, (64, 768), 4, 512, 32)
#: (m2) the same weights on ``model=2``: options, requests (count,
#: prompt lengths, new tokens).
MESH_MODEL = dict(slots=4, max_len=512, fold=False)
MESH_MODEL_REQUESTS = (4, (64, 256), 16)
#: (m3) whisper-base whole at f32 on ``data=2,model=2``, four ranks:
#: options (Whisper's text context), requests (each with its own frames).
MESH_WHISPER = dict(slots=4, max_len=448)
MESH_WHISPER_REQUESTS = (8, (4, 32), 32)
#: (m4) mixtral-8x22b at its widths, 2 layers, f32, expert-parallel on
#: ``model=2``: the tokens (batch, length) and f32's limit against the
#: unsharded forward, relative to max(1, max|logits|).
MESH_MIXTRAL = (4, 128)
MESH_F32_LIMIT = 1e-5
#: (m5) qwen2.5-14b at its widths cut to this many layers, f32, through
#: the partitioned serving program on ``model=2``: rows, prompt tokens,
#: decode steps (the cache holds the prompt and the steps).
MESH_M5_LAYERS = 4
MESH_M5 = (4, 256, 8)
#: Each rank's share of the card's memory, by group size: an overrun is
#: an error in the rank that made it.  The ranks' allocator maps its
#: segments in pages (``expandable_segments``): a qwen2.5-14b rank peaks
#: within 3 GB of its share, and each prefill chunk's f32 copy of the
#: head (2.9 GiB) would not find a whole free block of the cache's.
MESH_MEMORY_SHARE = {2: 0.48, 4: 0.24}
MESH_ALLOC_CONF = "expandable_segments:True"
MESH_TIMED_RUNS = 10
#: Time limits: the single-device runs' process, each group of ranks,
#: the phase.
MESH_SINGLE_TIMEOUT_S = 60
MESH_RANK_TIMEOUT_S = {2: 130, 4: 45}
MESH_TIMEOUT_S = 240
MESH_DIR = os.path.join(ROOT, "build", "chip_smoke_mesh")


def _qwen_bf16():
    """qwen2.5-14b whole with bf16 weights made on the card from seed 0,
    one layer at a time into stacked leaves allocated first: each weight
    drawn in f32 and cast, as ``precision="bf16"`` casts f32 masters.  A
    48-layer leaf drawn whole in f32 (13.6 GB) would leave a rank that
    shares the card 12 GB of reserved, unusable memory."""
    import dataclasses
    import torch
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.models import common as C
    from repro_torch.models import get_model, transformer
    cfg = dataclasses.replace(get_config("qwen2.5-14b"),
                              param_dtype="bfloat16")
    params = C.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device=DEVICE),
        get_model(cfg).init(device="meta"))
    init = C.Init.make(0, DEVICE)
    stacked = dict(C.tree_flatten(params["layers"]))
    for i in range(cfg.num_layers):
        for path, leaf in C.tree_flatten(transformer.layer_init(init, (),
                                                                cfg)):
            stacked[path][i].copy_(leaf)
    for name in ("embed", "head"):
        params[name].copy_(C.dense_init(init, params[name].shape,
                                        cfg.d_model, cfg.param_dtype))
    params["ln_f"].zero_()
    return repro_torch.compile(cfg, repro_torch.CompileOptions(
        target="engine", precision="bf16", device=DEVICE), params=params)


def _whisper_f32():
    import dataclasses
    import repro_torch
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("whisper-base"), dtype="float32")
    return repro_torch.compile(cfg, repro_torch.CompileOptions(
        target="engine", device=DEVICE), init_seed=0)


def _mixtral_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("mixtral-8x22b"),
                               num_layers=MIXTRAL_LAYERS, dtype="float32")


def _plain_requests(np, cfg, spec):
    """``spec`` (count, prompt lengths, new tokens) from seed 0; an audio
    request carries its own frames."""
    from repro_torch.serve import Request
    n, (lo, hi), new = spec
    rng = np.random.default_rng(0)
    reqs = []
    for uid in range(n):
        p = rng.integers(0, cfg.vocab, int(rng.integers(lo, hi + 1)))
        inputs = None
        if cfg.family == "audio":
            inputs = {"frames": rng.standard_normal(
                (cfg.n_frames, cfg.d_model)).astype(np.float32)}
        reqs.append(Request(uid=uid, prompt=p.astype(np.int32),
                            max_new_tokens=new, inputs=inputs))
    return reqs


def _mesh_options(case, mesh):
    from repro_torch.runtime import BucketPolicy
    from repro_torch.serve import SchedulerOptions
    if case == "m1":
        return SchedulerOptions(mesh=mesh, buckets=BucketPolicy(
            batch_buckets=MESH_QWEN_BUCKETS), **MESH_QWEN)
    return SchedulerOptions(mesh=mesh, **(MESH_MODEL if case == "m2"
                                          else MESH_WHISPER))


def _mesh_serve(torch, exe, opts, reqs):
    """Serve ``reqs`` (on ``opts.mesh``, or one device): the tokens and a
    row of what the run measured."""
    import gc
    import repro_torch
    torch.cuda.reset_peak_memory_stats()
    sched = repro_torch.serve(exe, opts)
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    step_ms = []
    while sched.queue_depth() or sched.num_active() or sched._prefilling:
        t = time.perf_counter()
        sched.step()
        step_ms.append((time.perf_counter() - t) * 1e3)
    serve_s = time.perf_counter() - t0
    summ = sched.summary()
    warm = sched.wait_warm(120.0)
    steps = sched.decode_steps()
    full = next(s for s in steps if s.batch == opts.slots)
    replays = sum(s.calls for s in steps if s.captured)
    rowless = sum(s.calls for s in steps if not s.local)
    row = {"requests": len(reqs), "serve_s": serve_s,
           "tokens_per_s": summ["tokens_per_s"],
           "total_new_tokens": summ["total_new_tokens"],
           "ttft_p50_ms": summ["ttft_p50"] * 1e3,
           "ttft_p99_ms": summ["ttft_p99"] * 1e3,
           "decode_steps": summ["decode_steps"],
           "prefill_chunks": summ["prefill_chunks"],
           "all_buckets_warm": warm,
           "every_step_a_replay": replays + rowless == summ["decode_steps"]
           and all(s.captured for s in steps if s.local),
           # the step loop's host ms per scheduler step after the last
           # admission (decode only where prefill is whole)
           "late_step_ms": statistics.median(step_ms[1:]) if len(
               step_ms) > 1 else None,
           "full_step_local_rows": full.local,
           "captured_steps": sum(s.captured for s in steps),
           "engines": summ["engines"],
           "pool_gb": sched._pool.bytes / 1e9 if sched._pool else None,
           "peak_gb": _peak_gb(torch)}
    if torch.distributed.is_initialized():
        world = torch.distributed.get_world_size()
        row["memory_share_gb"] = MESH_MEMORY_SHARE[world] * \
            torch.cuda.get_device_properties(0).total_memory / 1e9
    if sched.whole_prefill_programs():
        row["whole_prefill_pool_gb"] = sched._whole_pool.bytes / 1e9 \
            if sched._whole_pool else 0.0
        row["whole_prefill_lengths"] = [
            p.length for p in sched.whole_prefill_programs()]
    if "runtime" in summ:
        row["decode_stalls"] = summ["runtime"]["decode"]["compile_stalls"]
    if "prefix_cache" in summ:
        row["prefix_hits"] = summ["prefix_cache"]["hits"]
    if "sharding" in summ:
        sh = summ["sharding"]
        row["sharding"] = sh
        row["captured"] = sh["captured"]
        n = max(summ["decode_steps"], 1)
        row["per_step"] = {a: {"bytes": v["bytes"] / n, "ms": v["ms"] / n,
                               "collectives": v["count"] / n}
                           for a, v in sh["collectives"]["per_axis"].items()}
        row["faults"] = summ["faults"]
    if full.captured:
        # the full-slots step's replay (all this rank's rows), after the
        # run: every bucket is warm, so a device-wide synchronise is safe
        row["replay_ms"] = host_median_ms(full, runs=MESH_TIMED_RUNS,
                                          warmup=2)
    tokens = {c.uid: list(c.tokens) for c in sched.done}
    sched.shutdown()
    # the scheduler's pools go now, not when the cyclic collector finds
    # it (the next case on this rank needs the memory)
    del sched, steps, full
    gc.collect()
    torch.cuda.empty_cache()
    return tokens, row


def _mixtral_forward(torch, np, mesh=None):
    """mixtral-8x22b at its widths (MIXTRAL_LAYERS layers, f32) forward
    over MESH_MIXTRAL seeded tokens: unsharded, or expert-parallel on the
    live ``mesh``, each rank keeping only its experts."""
    import gc
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models import get_model, moe
    cfg = _mixtral_cfg()
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0, DEVICE)
    if mesh is not None:
        ffn = params["layers"]["ffn"]
        part = moe.local_experts(ffn, cfg, mesh)
        for name in ("wi_gate", "wi_up", "wo"):
            ffn[name] = part.pop(name).clone()     # the whole leaf freed
        del part
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    row = {"init_peak_gb": _peak_gb(torch),
           "held_gb": torch.cuda.memory_allocated() / 1e9,
           "expert_weights_gb": sum(
               params["layers"]["ffn"][n].numel() * 4 for n in
               ("wi_gate", "wi_up", "wo")) / 1e9}
    torch.cuda.reset_peak_memory_stats()
    b, s = MESH_MIXTRAL
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)
    with torch.inference_mode(), use_mesh(mesh):
        t0 = time.perf_counter()
        logits = model.forward(params, {"tokens": tokens})[0]
        torch.cuda.synchronize()
        row["forward_ms"] = (time.perf_counter() - t0) * 1e3
    row["peak_gb"] = _peak_gb(torch)
    out = logits.cpu().numpy()
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out, row


def _m5_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen2.5-14b"),
                               num_layers=MESH_M5_LAYERS, dtype="float32")


def _m5_collectives(torch):
    """Count and time the ``model`` collectives of the serving program
    (``dist.collectives._summed``: sums and maxes; ``_gathered``:
    gathers; ``exchange``: the prefill's all-to-all), each call between
    two device syncs, bytes those of its result; returns (the totals, a
    function that undoes the patch)."""
    import repro_torch.dist.collectives as col
    rec = {"count": 0, "bytes": 0, "ms": 0.0}
    real = {n: getattr(col, n) for n in ("_summed", "_gathered", "exchange")}

    def timed(fn):
        def run(x, axes, mesh, *a, **kw):
            if x.device.type == "meta" or \
                    mesh.canonical(axes) != ("model",):
                return fn(x, axes, mesh, *a, **kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(x, axes, mesh, *a, **kw)
            torch.cuda.synchronize()
            rec["count"] += 1
            rec["bytes"] += out.numel() * out.element_size()
            rec["ms"] += (time.perf_counter() - t) * 1e3
            return out
        return run
    for n, fn in real.items():
        setattr(col, n, timed(fn))

    def undo():
        for n, fn in real.items():
            setattr(col, n, fn)
    return rec, undo


def _m5_placed(prog, rows, max_len):
    """(the param bytes, the cache bytes) one rank holds under the
    reference's placement."""
    from repro_torch.launch.cells import placed_bytes
    from repro_torch.distributed.sharding import placements
    from repro_torch.models.common import tree_flatten
    whole = prog.model.init(0, "meta")
    specs = dict(tree_flatten(placements(prog.live, prog.model.param_axes(),
                                         whole)))
    params = sum(placed_bytes(prog.live, t, specs[p])
                 for p, t in tree_flatten(whole))
    cache = prog.model.init_cache(rows, max_len, "meta")
    cspecs = prog.cache_specs(rows, max_len)
    return params, sum(placed_bytes(prog.live, t, cspecs[k])
                       for k, t in cache.items())


def _qwen_m5(torch, np, mesh=None):
    """(m5) the partitioned serving program of qwen2.5-14b at its widths
    (MESH_M5_LAYERS layers, f32): a prefill of MESH_M5's prompts, then
    its greedy decode steps, on one device or on the live ``mesh`` (each
    rank its part of the params and the cache); (the gathered logits of
    each step, the tokens fed, a row of what it measured)."""
    import gc
    from repro_torch.launch.cells import serve_program
    from repro_torch.models.common import tree_leaves
    rows, prompt, steps = MESH_M5
    prog = serve_program(_m5_cfg(), mesh, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    params = prog.init_params(0)          # drawn whole, then cut
    gc.collect()
    torch.cuda.empty_cache()
    row = {"layers": MESH_M5_LAYERS, "rows": rows, "prompt": prompt,
           "steps": steps, "init_peak_gb": _peak_gb(torch),
           "held_param_bytes": sum(t.numel() * t.element_size()
                                   for t in tree_leaves(params))}
    tokens = np.random.default_rng(0).integers(
        0, prog.cfg.vocab, (rows, prompt)).astype(np.int32)
    cache = prog.init_cache(rows, prompt + steps)
    row["held_cache_bytes"] = sum(t.numel() * t.element_size()
                                  for t in cache.values())
    if mesh is not None:
        row["placed_param_bytes"], row["placed_cache_bytes"] = _m5_placed(
            prog, rows, prompt + steps)
        prog.plans          # the gathers' plans (a meta forward), untimed
        rec, undo = _m5_collectives(torch)
    torch.cuda.reset_peak_memory_stats()
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch = prog.local_batch({"tokens": torch.as_tensor(tokens,
                                                            device=DEVICE)})
        logits, cache = prog.prefill(params, batch, cache)
        whole = prog.gather_logits(logits, rows)[:, -1]
        torch.cuda.synchronize()
        row["prefill_ms"] = (time.perf_counter() - t) * 1e3
        if mesh is not None:
            row["prefill_collectives"] = dict(rec)
            rec.update(count=0, bytes=0, ms=0.0)
        out, fed, step_ms = [whole.float().cpu().numpy()], [], []
        lo, hi = prog.rows(rows)
        for _ in range(steps):
            tok = whole.argmax(-1)
            fed.append(tok.cpu().numpy())
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = prog.decode(params, cache,
                                        tok[lo:hi, None].int())
            whole = prog.gather_logits(logits, rows)[:, -1]
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            out.append(whole.float().cpu().numpy())
    finally:
        if mesh is not None:
            undo()
    row["step_ms"] = step_ms
    row["step_ms_median"] = statistics.median(step_ms)
    if mesh is not None:
        row["model_collectives_per_step"] = {k: v / steps
                                             for k, v in rec.items()}
    row["peak_gb"] = _peak_gb(torch)
    del params, cache, logits, whole
    gc.collect()
    torch.cuda.empty_cache()
    return np.stack(out), np.stack(fed), row


def mesh_rank_main(rank: int, world: int, work: str) -> int:
    """One rank of a mesh group: (m1) and (m2) then (m4) in a group of
    two, (m3) in a group of four; one JSON row a case on stdout, the
    tokens compared by the parent.  Every rank makes the same calls in
    the same order (the collectives pair up across ranks)."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.dist import MeshSpec
    from repro_torch.dist.collectives import LiveMesh
    torch.backends.cudnn.deterministic = True
    torch.cuda.set_per_process_memory_fraction(MESH_MEMORY_SHARE[world])
    dist.init_process_group(
        "gloo", init_method=f"file://{work}/rendezvous{world}", rank=rank,
        world_size=world)

    def say(case, mesh, tokens, row):
        print(json.dumps({"phase": "mesh", "case": case, "mesh": mesh,
                          "rank": rank, "tokens": tokens, **row}),
              flush=True)

    try:
        if world == 2:
            exe = _qwen_bf16()
            reqs, _ = _qwen_requests(np, exe.cfg, MESH_QWEN_REQUESTS)
            say("m1", "data=2", *_mesh_serve(
                torch, exe, _mesh_options("m1", "data=2"), reqs))
            reqs = _plain_requests(np, exe.cfg, MESH_MODEL_REQUESTS)
            say("m2", "model=2", *_mesh_serve(
                torch, exe, _mesh_options("m2", "model=2"), reqs))
            del exe, reqs
            gc.collect()
            torch.cuda.empty_cache()
            held_before = torch.cuda.memory_allocated() / 1e9
            mesh = LiveMesh(MeshSpec.parse("model=2"), torch.device(DEVICE))
            logits, row = _mixtral_forward(torch, np, mesh)
            want = np.load(os.path.join(work, "mixtral.npy"))
            row["max_abs_err"] = float(np.abs(logits - want).max())
            row["limit"] = MESH_F32_LIMIT * max(1.0, float(np.abs(
                want).max()))
            row["bit_equal"] = bool(np.array_equal(logits, want))
            row["held_before_gb"] = held_before
            say("m4", "model=2", None, row)
            del logits, want
            gc.collect()
            torch.cuda.empty_cache()
            logits, fed, row = _qwen_m5(torch, np, mesh)
            with np.load(os.path.join(work, "qwen_m5.npz")) as z:
                want, want_fed = z["logits"], z["tokens"]
            row["max_abs_err"] = float(np.abs(logits - want).max())
            row["limit"] = MESH_F32_LIMIT * max(1.0, float(np.abs(
                want).max()))
            row["tokens_equal"] = bool(np.array_equal(fed, want_fed))
            say("m5", "model=2", None, row)
        else:
            exe = _whisper_f32()
            reqs = _plain_requests(np, exe.cfg, MESH_WHISPER_REQUESTS)
            say("m3", "data=2,model=2", *_mesh_serve(
                torch, exe, _mesh_options("m3", "data=2,model=2"), reqs))
    finally:
        from repro_torch.dist.collectives import destroy_process_group
        destroy_process_group()
    return 0


def _mesh_ranks(world: int, work: str):
    """Run a group of ``world`` rank processes on the card to their end:
    (their exit codes, their rows)."""
    import threading
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF=MESH_ALLOC_CONF)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
         str(world), work], cwd=ROOT, stdout=subprocess.PIPE, text=True,
        env=env) for r in range(world)]
    timers = [threading.Timer(MESH_RANK_TIMEOUT_S[world], p.kill)
              for p in procs]
    for t in timers:
        t.start()
    rows = []
    try:
        for p in procs:
            out, _ = p.communicate()
            rows += [json.loads(line) for line in out.splitlines()
                     if line.startswith("{")]
    finally:
        for t in timers:
            t.cancel()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], rows


def mesh_single_main(work: str) -> int:
    """The single-device runs of (m1)-(m3) and the unsharded forward of
    (m4), in a process of their own (every byte of the card is returned
    when it exits, before the ranks start): their rows on stdout, the
    tokens to ``work/want.json``, the logits to ``work/mixtral.npy``."""
    import gc
    import numpy as np
    import torch
    torch.backends.cudnn.deterministic = True
    want = {}
    exe = _qwen_bf16()
    for case, reqs in (
            ("m1", _qwen_requests(np, exe.cfg, MESH_QWEN_REQUESTS)[0]),
            ("m2", _plain_requests(np, exe.cfg, MESH_MODEL_REQUESTS))):
        want[case], row = _mesh_serve(torch, exe, _mesh_options(case, None),
                                      reqs)
        emit({"phase": "mesh", "case": case, "mesh": None, **row})
    del exe
    gc.collect()
    torch.cuda.empty_cache()
    exe = _whisper_f32()
    want["m3"], row = _mesh_serve(
        torch, exe, _mesh_options("m3", None),
        _plain_requests(np, exe.cfg, MESH_WHISPER_REQUESTS))
    emit({"phase": "mesh", "case": "m3", "mesh": None, **row})
    del exe
    logits, row = _mixtral_forward(torch, np)
    np.save(os.path.join(work, "mixtral.npy"), logits)
    emit({"phase": "mesh", "case": "m4", "mesh": None, **row})
    del logits
    logits, fed, row = _qwen_m5(torch, np)
    np.savez(os.path.join(work, "qwen_m5.npz"), logits=logits, tokens=fed)
    emit({"phase": "mesh", "case": "m5", "mesh": None, **row})
    with open(os.path.join(work, "want.json"), "w") as f:
        json.dump(want, f)
    return 0


def mesh_main() -> int:
    """The mesh phase, in its own process: the single-device runs and the
    unsharded forward in a child, then the rank processes that share the
    card (over gloo), each held to them."""
    import shutil
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke --mesh: no CUDA device", file=sys.stderr)
        return 2
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("TF32 is on; the f32 comparisons need it off")
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--mesh-single", MESH_DIR], cwd=ROOT,
                         stdout=subprocess.PIPE, text=True,
                         timeout=MESH_SINGLE_TIMEOUT_S)
    for line in res.stdout.splitlines():
        if line.startswith("{"):
            emit(json.loads(line))
    emit({"phase": "mesh", "case": "single_device_done",
          "seconds": time.perf_counter() - t0, "rc": res.returncode})
    if res.returncode:
        raise SystemExit(f"mesh phase failed: the single-device runs "
                         f"exited {res.returncode}")
    with open(os.path.join(MESH_DIR, "want.json")) as f:
        want = json.load(f)

    problems = []
    expected = {2: ("m1", "m2", "m4", "m5"), 4: ("m3",)}
    for world in (2, 4):
        t0 = time.perf_counter()
        rcs, rows = _mesh_ranks(world, MESH_DIR)
        emit({"phase": "mesh", "case": "group_done", "ranks": world,
              "rcs": rcs, "seconds": time.perf_counter() - t0,
              "limit_s": MESH_RANK_TIMEOUT_S[world]})
        got = sorted((r["case"], r["rank"]) for r in rows)
        if rcs != [0] * world or got != sorted(
                (c, r) for c in expected[world] for r in range(world)):
            problems.append(f"mesh: {world} ranks exited {rcs} with rows "
                            f"{got}")
        for row in rows:
            case, tokens = row["case"], row.pop("tokens")
            if tokens is not None:
                agree = sum(tokens.get(u) == t for u, t in want[case].items())
                row["requests_equal"] = agree
                if agree != len(want[case]):
                    problems.append(
                        f"mesh {case} rank {row['rank']}: {agree} of "
                        f"{len(want[case])} requests' tokens equal to "
                        f"single-device")
            emit(row)
            if case == "m1" and not (row["every_step_a_replay"]
                                     and row["captured"]
                                     and row["decode_stalls"] == 0):
                problems.append(f"mesh m1 rank {row['rank']}: every step a "
                                f"replay {row['every_step_a_replay']}, "
                                f"stalls {row['decode_stalls']}")
            if case in ("m2", "m3") and row["captured"]:
                problems.append(f"mesh {case}: a step that gathers over "
                                f"gloo reports itself captured")
            if case in ("m2", "m3") and not (
                    row.get("whole_prefill_lengths")
                    and row["peak_gb"] <= row["memory_share_gb"]):
                problems.append(
                    f"mesh {case} rank {row['rank']}: whole-prompt programs "
                    f"{row.get('whole_prefill_lengths')}, peak "
                    f"{row['peak_gb']} GB (share {row['memory_share_gb']})")
            if case in ("m1", "m2", "m3") and row["faults"]:
                problems.append(f"mesh {case}: faults {row['faults']}")
            if "engines" in row:
                problems += _engine_problems(
                    f"mesh {case} rank {row['rank']}", row["engines"])
            if case in ("m4", "m5") and not row["max_abs_err"] <= \
                    row["limit"]:
                problems.append(f"mesh {case} rank {row['rank']}: err "
                                f"{row['max_abs_err']} over {row['limit']}")
            if case == "m5" and not (
                    row["tokens_equal"]
                    and row["held_param_bytes"] == row["placed_param_bytes"]
                    and row["held_cache_bytes"] == row["placed_cache_bytes"]
                    and row["model_collectives_per_step"]["count"] > 0):
                problems.append(
                    f"mesh m5 rank {row['rank']}: tokens equal "
                    f"{row['tokens_equal']}, held {row['held_param_bytes']}"
                    f"/{row['held_cache_bytes']} bytes, placed "
                    f"{row['placed_param_bytes']}/"
                    f"{row['placed_cache_bytes']}, collectives "
                    f"{row['model_collectives_per_step']}")
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    if problems:
        raise SystemExit("mesh phase failed: " + "; ".join(problems))
    return 0


def phase_mesh():
    """The mesh phase in its child process."""
    return phase_child("--mesh", MESH_TIMEOUT_S, "mesh")


# ---------------------------------------------------------------------------
# The train phase (a child process: ``python3 chip_smoke.py --train``)
# ---------------------------------------------------------------------------
#: (t1): one train step of each SMOKE config, batch x tokens, on the card
#: and on the CPU; the f32 limits: the loss x max(1, |loss|), every
#: gradient leaf x max(1, max|g|), grad_norm relative; bf16's loss is
#: held to QUANT_BUDGET x max(1, |loss|).
TRAIN_SMOKE = (2, 16)
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
TRAIN_NORM_TOL = 1e-5
#: (t2): minicpm-2b at its published widths (src/repro/launch/train.py's
#: default arch): batch x tokens x steps, one batch of SyntheticTokens
#: (seed 0) repeated, under WSD with its warm-up over all the steps, at
#: a peak LR of 1e-5 (checked: the last loss below the first), then from
#: the same start at the launcher's 3e-3 (its losses reported); a
#: cast_params step's loss against the f32-compute loss of the same
#: state (tests/test_perf_flags.py:95's bound).
TRAIN_FULL = (4, 512, 6)
TRAIN_LR = 1e-5
TRAIN_LAUNCHER_LR = 3e-3
TRAIN_CAST_TOL = 0.02
#: (t3): the launcher at SMOKE size, 10 steps sent SIGTERM in the middle
#: of step 5's in-place update, then resumed to 10, against 10 steps
#: uninterrupted, each run a process under deterministic algorithms.
TRAIN_RESUME = ("--arch", "minicpm-2b", "--smoke", "--batch", "2",
                "--seq", "16", "--ckpt-every", "3", "--log-every", "1",
                "--steps", "10")
TRAIN_PAUSE_AT = 5
TRAIN_RUN_TIMEOUT_S = 60
TRAIN_TIMEOUT_S = 260
#: (t4): captured steps against eager ones, bit for bit: how many, and
#: minicpm-2b's depth there (its published widths, 40 layers cut to 4).
TRAIN_BITS_STEPS = 3
TRAIN_BITS_LAYERS = 4
TRAIN_BITS_TIMEOUT_S = 120
TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_train")
#: The launcher under deterministic algorithms; its train step at
#: index ``argv[1]`` (-1: none) is held, once its replay is launched and
#: the step is in flight on the card, until SIGTERM has arrived, with
#: ``PAUSED`` printed first.
RESUME_SCRIPT = """
import os, select, signal, sys
sys.path.insert(0, {src!r})
import torch
torch.use_deterministic_algorithms(True)
import repro_torch.training as training
from repro_torch.launch.train import main

pause_at = int(sys.argv[1])
woken, wake = os.pipe()
os.set_blocking(wake, False)
signal.set_wakeup_fd(wake)
real_make = training.make_jitted_train_step


def make(*args, **kwargs):
    step = real_make(*args, **kwargs)
    calls = []

    def paused(state, batch):
        out = step(state, batch)
        calls.append(1)
        if len(calls) - 1 == pause_at:
            print("PAUSED", flush=True)
            select.select([woken], [], [], {timeout})
        return out
    return paused


training.make_jitted_train_step = make
sys.exit(main(sys.argv[2:]))
"""


def _loss_and_grads(torch, model, params, batch):
    """(flatten paths, loss, the gradient of each param leaf)."""
    from repro_torch.models.common import tree_flatten, tree_unflatten
    paths, leaves = zip(*tree_flatten(params))
    ins = [p.detach().requires_grad_() for p in leaves]
    loss = model.loss(tree_unflatten(list(paths), ins), batch)
    grads = torch.autograd.grad(loss, ins, allow_unused=True,
                                materialize_grads=True)
    return paths, loss.detach(), grads


def phase_train_smoke(torch, np):
    """(t1) Each SMOKE config's loss, gradients and one train step on the
    card against the CPU, the same params (made on the CPU from a seed)
    and batch: at f32, then at the configured bf16."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.common import tree_map
    from repro_torch.training import (OptConfig, TrainConfig, adamw_init,
                                      make_jitted_train_step)
    problems = []
    b, s = TRAIN_SMOKE
    tc = TrainConfig(opt=OptConfig(lr=1e-3, eps=1e-6, total_steps=10,
                                   warmup_steps=0))
    for arch in ENGINE_ARCHS:
        t0 = time.perf_counter()
        base = get_config(arch, smoke=True)
        params = get_model(base).init(0, "cpu")
        batch = _smoke_batch(np, base, b, s)
        batch["labels"] = np.random.default_rng(1).integers(
            0, base.vocab, (b, s)).astype(np.int32)
        row = {"phase": "train", "case": "smoke", "arch": arch}
        for dtype in ("float32", base.dtype):
            model = get_model(dataclasses.replace(base, dtype=dtype))
            out = {}
            for dev in ("cpu", DEVICE):
                p = tree_map(lambda t: t.to(dev), params)
                feed = {k: torch.as_tensor(v, device=dev)
                        for k, v in batch.items()}
                paths, loss, grads = _loss_and_grads(torch, model, p, feed)
                state = {"params": p, "opt": adamw_init(p)}
                # not donated: on the CPU p is the params themselves; on
                # the card the first call is a replay
                step = make_jitted_train_step(model, tc, donate=False)
                _, met = step(state, feed)
                out[dev] = (float(loss), grads, float(met["loss"]),
                            float(met["grad_norm"]))
                if dev == DEVICE:
                    row[f"{dtype}_step_captured"] = step.captured
                    if not step.captured:
                        problems.append(f"train {arch} {dtype}: the card's "
                                        f"step is not captured")
                del step
            (lw, gw, sw, nw), (lg, gg, sg, ng) = out["cpu"], out[DEVICE]
            if dtype == "float32":
                lim = TRAIN_LOSS_TOL * max(1.0, abs(lw))
                worst, leaf = 0.0, None
                for path, a, g in zip(paths, gg, gw):
                    ratio = float((a.cpu() - g).abs().max()) / max(
                        1.0, float(g.abs().max()))
                    if ratio >= worst:
                        worst, leaf = ratio, path
                norm_err = abs(ng - nw) / nw
                row.update(f32_loss=lw, f32_loss_err=abs(lg - lw),
                           f32_loss_limit=lim,
                           f32_step_loss_err=abs(sg - sw),
                           f32_grad_err_ratio=worst, f32_grad_leaf=leaf,
                           f32_grad_limit_ratio=TRAIN_GRAD_TOL,
                           f32_grad_norm=nw, f32_grad_norm_rel_err=norm_err)
                if (abs(lg - lw) > lim or abs(sg - sw) > lim
                        or worst > TRAIN_GRAD_TOL
                        or norm_err > TRAIN_NORM_TOL):
                    problems.append(
                        f"train {arch} f32: loss err {abs(lg - lw)} (limit "
                        f"{lim}), step loss err {abs(sg - sw)}, gradient "
                        f"err {worst} x max(1, max|g|) at {leaf}, "
                        f"grad_norm rel err {norm_err}")
            else:
                lim = QUANT_BUDGET * max(1.0, abs(lw))
                finite = all(bool(torch.isfinite(g).all()) for g in gg)
                row.update(bf16_loss_err=abs(lg - lw), bf16_loss_limit=lim,
                           bf16_grads_finite=finite)
                if abs(lg - lw) > lim or not finite:
                    problems.append(f"train {arch} {dtype}: loss err "
                                    f"{abs(lg - lw)} (limit {lim}), grads "
                                    f"finite {finite}")
        row["seconds"] = time.perf_counter() - t0
        emit(row)
    return problems


def _resume_run(ck: str, pause_at: int = -1):
    """The launcher in a process of its own, under deterministic
    algorithms (cuBLAS's workspace set before CUDA starts), and a thread
    that reads its lines and sends it SIGTERM once it has ``PAUSED``."""
    import signal
    import threading
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    script = RESUME_SCRIPT.format(src=os.path.join(ROOT, "src"),
                                  timeout=TRAIN_RUN_TIMEOUT_S)
    proc = subprocess.Popen(
        [sys.executable, "-c", script, str(pause_at), *TRAIN_RESUME,
         "--ckpt", ck, "--device", DEVICE], cwd=ROOT,
        stdout=subprocess.PIPE, text=True, env=env)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if lines[-1] == "PAUSED":
                proc.send_signal(signal.SIGTERM)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    return proc, reader, lines


def _finish(run):
    """(exit code, {step: logged row}, lines) of a launcher run."""
    proc, reader, lines = run
    try:
        proc.wait(timeout=TRAIN_RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    reader.join()
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    return proc.returncode, {r["step"]: r for r in rows}, lines


def start_train_resume():
    """(t3a) on a thread of its own: its first runs in parallel (10 steps
    preempted at step 5, and 10 uninterrupted), then the resumed run.
    Returns a function that waits for it and returns its problems."""
    import threading
    out = []

    def run():
        try:
            out.extend(phase_train_resume((time.perf_counter(), [
                _resume_run(os.path.join(TRAIN_DIR, "cut"), TRAIN_PAUSE_AT),
                _resume_run(os.path.join(TRAIN_DIR, "whole"))])))
        except Exception as e:                  # reported, never lost
            out.append(f"train resume: {e!r}")

    thread = threading.Thread(target=run)
    thread.start()

    def wait():
        thread.join()
        return out
    return wait


def phase_train_resume(started):
    """(t3a) The launcher on the card at SMOKE size, sent SIGTERM in the
    middle of step 5's update: exit code 143 after saving step 5; then
    resumed to 10, against 10 uninterrupted steps (``started`` by
    :func:`start_train_resume`): every logged loss, lr and grad_norm
    equal, and the step-9 checkpoints equal byte for byte."""
    import filecmp
    from repro_torch.checkpoint import Checkpointer
    t0, runs = started
    cut = os.path.join(TRAIN_DIR, "cut")
    whole = os.path.join(TRAIN_DIR, "whole")
    (rc_cut, first, cut_lines), (rc_whole, straight, _) = [
        _finish(r) for r in runs]
    cut_steps = Checkpointer(cut).all_steps()
    rc_resumed, resumed, _ = _finish(_resume_run(cut))
    logged = {**first, **resumed}
    keys = ("loss", "lr", "grad_norm")
    same = sorted(logged) == sorted(straight) == list(range(10)) and all(
        {k: logged[i][k] for k in keys} == {k: straight[i][k] for k in keys}
        for i in range(10))
    step9 = [os.path.join(d, "step_000000009") for d in (cut, whole)]
    names = sorted(os.listdir(step9[1])) if os.path.isdir(step9[1]) else []
    match = filecmp.cmpfiles(*step9, names, shallow=False)[0] if names \
        else []
    ck_equal = bool(names) and match == names
    preempted = "PAUSED" in cut_lines and sorted(first) == list(range(6)) \
        and cut_steps == [3, 5]
    row = {"phase": "train", "case": "resume",
           "rcs": [rc_cut, rc_whole, rc_resumed],
           "cut_steps": sorted(first), "cut_checkpoints": cut_steps,
           "resumed_steps": sorted(resumed),
           "losses_resumed": [resumed.get(i, {}).get("loss")
                              for i in range(6, 10)],
           "losses_uninterrupted": [straight.get(i, {}).get("loss")
                                    for i in range(6, 10)],
           "logs_equal": same, "checkpoint_files": len(names),
           "checkpoint_bit_equal": ck_equal,
           "seconds": time.perf_counter() - t0}
    emit(row)
    if [rc_cut, rc_whole, rc_resumed] != [143, 0, 0] or not preempted \
            or not same or not ck_equal or sorted(resumed) != [6, 7, 8, 9]:
        return [f"train resume: exit codes {row['rcs']} (want 143, 0, 0), "
                f"cut at steps {row['cut_steps']} with checkpoints "
                f"{cut_steps}, logs equal {same}, step-9 checkpoint "
                f"bit-equal {ck_equal}, resumed steps "
                f"{row['resumed_steps']}"]
    return []


def _host_ram_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def phase_train_full(torch, np):
    """(t2) minicpm-2b at its published widths trained on the card, then
    (t3b) its state saved asynchronously and restored bit-equal; then the
    same start trained at the launcher's LR.  (t3a) runs beside (t3b) and
    the launcher-LR run."""
    import dataclasses
    import shutil
    import repro_torch.training.optim as optim_mod
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import get_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import (OptConfig, TrainConfig, init_state,
                                      make_jitted_train_step)
    from repro_torch.training.train import make_train_step
    problems = []
    cfg = get_config("minicpm-2b")
    model = get_model(cfg)
    b, s, steps = TRAIN_FULL
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(model, 0, DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state))
    opt = OptConfig(lr=TRAIN_LR, total_steps=steps, warmup_steps=steps,
                    schedule=cfg.lr_schedule)
    step = make_jitted_train_step(model, TrainConfig(opt=opt), donate=True)
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in SyntheticTokens(
        DataConfig(vocab=cfg.vocab, global_batch=b, seq_len=s,
                   seed=0)).batch(0).items()}

    # The optimizer's device time, between CUDA events, in the eager
    # first step: a replay runs no Python, and an event recorded while
    # the step is captured is not timed.
    events = []
    real = optim_mod.adamw_update

    def timed(*a, **kw):
        if torch.cuda.is_current_stream_capturing():
            return real(*a, **kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*a, **kw)
        end.record()
        events.append((start, end))
        return out

    optim_mod.adamw_update = timed
    losses, norms, lrs, host_ms = [], [], [], []
    try:
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, met = step(state, batch)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
            lrs.append(float(met["lr"]))
    finally:
        optim_mod.adamw_update = real
    peak = _peak_gb(torch)
    step_ms = statistics.median(host_ms[1:])
    opt_ms = events[0][0].elapsed_time(events[0][1])
    tokens = b * s
    model_flops = 6.0 * n_params * tokens
    tflops = model_flops / (step_ms / 1e3) / 1e12
    prof = device_profile(lambda: step(state, batch), iters=1)
    dev_ms = sum(v[1] for v in prof.values())
    top = sorted(prof.items(), key=lambda kv_: -kv_[1][1])[:10]
    captured, eager_ms = step.captured, step.warm_ms
    pool_gb = step.pool.bytes / 1e9 if step.pool else 0.0
    step.release()        # its pool, before the eager cast step's
    with torch.no_grad():
        f32_loss = float(model.loss(state["params"], batch))
    # one step, run eagerly: capturing it would cost a second pool
    cast = make_train_step(model, TrainConfig(opt=opt, cast_params=True),
                           donate=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, met = cast(state, batch)
    torch.cuda.synchronize()
    cast_ms = (time.perf_counter() - t) * 1e3
    cast_loss = float(met["loss"])
    finite = all(np.isfinite(losses)) and all(np.isfinite(norms)) and \
        np.isfinite(cast_loss)
    row = {"phase": "train", "case": "minicpm-2b", "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab, "params": n_params,
           "state_gb": state_bytes / 1e9, "dtype": cfg.dtype,
           "param_dtype": cfg.param_dtype, "remat": cfg.remat,
           "schedule": cfg.lr_schedule, "batch": b, "tokens": s,
           "init_s": init_s, "peak_lr": TRAIN_LR, "warmup_steps": steps,
           "lrs": lrs, "losses": losses, "grad_norms": norms,
           "host_ms": host_ms, "step_ms": step_ms, "captured": captured,
           "eager_first_step_ms": eager_ms,
           "first_call_ms": host_ms[0], "pool_gb": pool_gb,
           "events_eager_only": len(events) == 1,
           "tokens_per_s": tokens / step_ms * 1e3,
           "model_tflops": tflops,
           "bf16_peak_share": tflops * 1e12 / BF16_FLOPS_PER_S,
           "optimizer_ms": opt_ms,
           "optimizer_ms_from": "the eager first step, CUDA events",
           "device_ms": dev_ms,
           "busy_share": dev_ms / step_ms,
           "launches": sum(v[0] for v in prof.values()),
           "peak_gb": peak,
           "top_ops": [{"name": k[:100], "launches": n, "ms": ms}
                       for k, (n, ms) in top],
           "cast_params_ms": cast_ms, "cast_params_loss": cast_loss,
           "f32_compute_loss": f32_loss,
           "cast_params_loss_err": abs(cast_loss - f32_loss),
           "cast_params_limit": TRAIN_CAST_TOL}
    emit(row)
    if not finite or not losses[-1] < losses[0]:
        problems.append(f"train minicpm-2b: losses {losses}, grad norms "
                        f"{norms}: not finite or not falling")
    if not (captured and len(events) == 1):
        problems.append(f"train minicpm-2b: captured {captured}, "
                        f"{len(events)} eager optimizer updates (want 1)")
    if not abs(cast_loss - f32_loss) < TRAIN_CAST_TOL:
        problems.append(f"train minicpm-2b cast_params: loss {cast_loss} "
                        f"against {f32_loss}")

    # (t3a) starts here: its small processes run beside (t3b), whose
    # copy and write times are taken beside them, and the launcher-LR
    # run, which times nothing.
    resume = start_train_resume()

    # (t3b) the state saved asynchronously, then restored to the host.
    root = os.path.join(TRAIN_DIR, "full")
    os.makedirs(root, exist_ok=True)
    disk, ram = shutil.disk_usage(root).free, _host_ram_available()
    whole = disk >= 2 * state_bytes and ram >= 2 * state_bytes
    tree = state if whole else state["params"]
    tree_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    emit({"phase": "train", "case": "checkpoint_plan",
          "free_disk_gb": disk / 1e9, "host_ram_available_gb": ram / 1e9,
          "state_gb": state_bytes / 1e9,
          "saved": "state" if whole else "params (disk or RAM under 2 x "
                                         "the state)",
          "gb": tree_bytes / 1e9, "beside": "t3a"})
    ck = Checkpointer(root)
    done = int(state["opt"]["step"]) - 1
    torch.cuda.synchronize()
    t = time.perf_counter()
    ck.save(done, tree)
    blocked_ms = (time.perf_counter() - t) * 1e3
    ck.wait()
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    out = ck.restore(done, tree, device="cpu")
    restore_s = time.perf_counter() - t
    equal = all(torch.equal(a, z.cpu()) for a, z in
                zip(tree_leaves(out), tree_leaves(tree)))
    del out
    shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "train", "case": "checkpoint",
          "gb": tree_bytes / 1e9, "leaves": len(tree_leaves(tree)),
          "blocked_ms": blocked_ms, "write_s": write_s,
          "restore_s": restore_s, "bit_equal": equal})
    if not equal:
        problems.append("train checkpoint: the restored state differs")
    del state, tree

    # The same start and warm-up at the launcher's LR (its first step
    # eager, then replays).
    state = init_state(model, 0, DEVICE)
    step = make_jitted_train_step(model, TrainConfig(
        opt=dataclasses.replace(opt, lr=TRAIN_LAUNCHER_LR)), donate=True)
    high = []
    for _ in range(steps):
        state, met = step(state, batch)
        high.append((float(met["loss"]), float(met["grad_norm"]),
                     float(met["lr"])))
    del state
    emit({"phase": "train", "case": "minicpm-2b_launcher_lr",
          "peak_lr": TRAIN_LAUNCHER_LR, "warmup_steps": steps,
          "lrs": [x[2] for x in high], "losses": [x[0] for x in high],
          "grad_norms": [x[1] for x in high]})
    if not all(np.isfinite(x[:2]).all() for x in high):
        problems.append(f"train minicpm-2b at LR {TRAIN_LAUNCHER_LR}: "
                        f"losses and grad norms {high} not finite")
    return problems + resume()


def train_main() -> int:
    """The train phase, alone in this process: minicpm-2b's training
    state takes 43.6 GB of the card."""
    import shutil
    import torch
    import numpy as np
    if not torch.cuda.is_available():
        print("chip_smoke --train: no CUDA device", file=sys.stderr)
        return 2
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("TF32 is on; the f32 comparisons need it off")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    os.makedirs(TRAIN_DIR)
    t0 = time.perf_counter()
    # (t4) beside (t1): both hold SMOKE configs and (t4) a 4-layer
    # minicpm-2b (~18 GB), done before (t2) takes ~50 GB
    bits = start_child("--train-bits", TRAIN_BITS_TIMEOUT_S, env=dict(
        os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    problems = phase_train_smoke(torch, np)
    emit({"phase": "train", "case": "smoke_done",
          "seconds": time.perf_counter() - t0})
    problems += finish_child(bits, "train_bits")
    problems += phase_train_full(torch, np)      # (t3a) runs inside it
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    if problems:
        raise SystemExit("train phase failed: " + "; ".join(problems))
    return 0


def phase_train():
    """The train phase in its child process."""
    return phase_child("--train", TRAIN_TIMEOUT_S, "train")


def _bits_case(torch, np, model, tc, batches):
    """TRAIN_BITS_STEPS captured steps (``make_jitted_train_step``,
    donated) against as many eager ones (``make_train_step``) from clones
    of one state: (metrics and every state leaf bit-equal, captured,
    pool GB, peak GB)."""
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.training import init_state, make_jitted_train_step
    from repro_torch.training.train import make_train_step
    torch.cuda.reset_peak_memory_stats()
    state = init_state(model, 0, DEVICE)
    eager_state = tree_map(torch.clone, state)
    step = make_jitted_train_step(model, tc, donate=True)
    eager = make_train_step(model, tc, donate=True)
    equal = True
    for batch in batches:
        _, met = step(state, batch)
        _, want = eager(eager_state, batch)
        equal &= all(torch.equal(met[k], want[k]) for k in want)
    equal &= all(torch.equal(a, b) for a, b in
                 zip(tree_leaves(state), tree_leaves(eager_state)))
    out = (equal, step.captured, step.pool.bytes / 1e9 if step.pool else 0.0,
           _peak_gb(torch))
    step.release()
    del state, eager_state, step
    torch.cuda.empty_cache()
    return out


def train_bits_main() -> int:
    """(t4) Captured train steps against eager ones, bit for bit, under
    ``torch.use_deterministic_algorithms(True)``, in a process of its
    own started with ``CUBLAS_WORKSPACE_CONFIG`` set (the rest of the
    train phase times cuBLAS at its default workspace): each SMOKE
    config at f32 in two microbatches, then minicpm-2b at its published
    widths cut to TRAIN_BITS_LAYERS layers, TRAIN_FULL's batch."""
    import dataclasses
    import torch
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import get_model
    from repro_torch.training import OptConfig, TrainConfig
    torch.use_deterministic_algorithms(True)
    problems = []
    opt = OptConfig(lr=1e-3, eps=1e-6, total_steps=10, warmup_steps=0)
    b, s = TRAIN_SMOKE
    cases = []
    for arch in ENGINE_ARCHS:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32")
        batches = []
        for i in range(TRAIN_BITS_STEPS):
            batch = _smoke_batch(np, cfg, 2 * b, s)
            batch["labels"] = np.random.default_rng(i).integers(
                0, cfg.vocab, (2 * b, s)).astype(np.int32)
            batches.append(batch)
        cases.append((arch, "smoke", cfg,
                      TrainConfig(opt=opt, microbatches=2), batches))
    cfg = dataclasses.replace(get_config("minicpm-2b"),
                              num_layers=TRAIN_BITS_LAYERS)
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab,
                                      global_batch=TRAIN_FULL[0],
                                      seq_len=TRAIN_FULL[1], seed=0))
    cases.append(("minicpm-2b", f"published widths, {cfg.num_layers} of "
                  f"40 layers", cfg, TrainConfig(opt=opt),
                  [data.batch(i) for i in range(TRAIN_BITS_STEPS)]))
    for arch, size, cfg, tc, batches in cases:
        t0 = time.perf_counter()
        equal, captured, pool_gb, peak = _bits_case(
            torch, np, get_model(cfg), tc, batches)
        emit({"phase": "train", "case": "captured_vs_eager", "arch": arch,
              "size": size, "layers": cfg.num_layers,
              "d_model": cfg.d_model, "dtype": cfg.dtype,
              "microbatches": tc.microbatches,
              "batch": list(batches[0]["tokens"].shape),
              "steps": TRAIN_BITS_STEPS, "bit_equal": equal,
              "captured": captured, "pool_gb": pool_gb, "peak_gb": peak,
              "seconds": time.perf_counter() - t0})
        if not (equal and captured):
            problems.append(f"train {arch} ({cfg.num_layers} layers): "
                            f"captured {captured}, bit-equal to eager "
                            f"{equal}")
    if problems:
        raise SystemExit("train_bits failed: " + "; ".join(problems))
    return 0


# ---------------------------------------------------------------------------
# The train_mesh phase (a child process: ``python3 chip_smoke.py
# --train-mesh``)
# ---------------------------------------------------------------------------
#: (tm1): the SMOKE configs at f32, three mesh train steps against the
#: one-device computation of each step on the card (the CPU tests'
#: limits): {ranks: [(case, mesh, arch, config overrides, TrainConfig
#: overrides)]}, global batch x tokens.
#: Every case with a ``model`` axis runs with its compute split over it
#: (heads, MLP columns, vocab; the MoE expert-parallel).
TM1 = {4: [("tm1", "data=2,model=2", "qwen2.5-14b", {}, {}),
           ("tm1", "data=2,model=2", "mixtral-8x22b", {}, {}),
           ("tm1", "data=2,model=2", "deepseek-v3-671b", {}, {})],
       2: [("tm1", "model=2", "qwen2.5-14b", {"tp_psum": True}, {}),
           ("tm1", "model=2", "whisper-base", {}, {}),
           ("tm1", "model=2", "recurrentgemma-9b", {}, {}),
           ("tm1", "data=2", "minicpm-2b", {}, {"microbatches": 2}),
           ("tm1", "data=2", "mixtral-8x22b", {}, {})]}
TM1_BATCH = (4, 16)
TM_STEPS = 3
#: (tm2): minicpm-2b at its published widths on data=2, depth cut from
#: 40 layers to TM2[3] (each of the two ranks holds its part of the state
#: on the one card, the reference's placement; 6 rather than 12 layers
#: since the dry-run phase, 4 since the captured programs' rows, to keep
#: the script's time: the gathers' and the reduce's GB/s are what it
#: measures):
#: global batch x tokens x steps x layers, WSD warm-up over the steps to
#: TRAIN_LR; step 1's loss and grad_norm against the one-device step on
#: the same batch and params (2 steps since the partitioned state: its
#: gathers doubled the step's time).
TM2 = (4, 512, 2, 4)
TM2_LOSS_TOL = 1e-4
TM2_NORM_TOL = 1e-2
#: (tm3): mixtral-8x22b at its widths on model=2, expert-parallel, f32,
#: depth cut to 1 layer, each rank holding only its 4 experts' state:
#: batch x tokens, LR; the loss, every gradient leaf and one step's
#: grad_norm and params against one device (params within 1e-4 x
#: max(1, max|p|)).
TM3 = (4, 128, 1)
TM3_LR = 1e-5
TM3_PARAM_TOL = 1e-4
#: (tm4): minicpm-2b at its published widths (d_model 2304, 36 heads,
#: d_ff 5760, vocab 122753: an odd vocab, so the vocab rows split
#: unevenly) on model=2 with its compute split over ``model``, depth cut
#: from 40 layers to TM4[3]: global batch x tokens x steps x layers, WSD
#: warm-up over the steps to TRAIN_LR; step 1's loss and grad_norm
#: against the one-device step within tm2's limits.
TM4 = (4, 512, 2, 4)
TM_RANK_TIMEOUT_S = {4: 150, 2: 330}
TRAIN_MESH_TIMEOUT_S = 500
TRAIN_MESH_DIR = os.path.join(ROOT, "build", "chip_smoke_train_mesh")
TM_ALLOC_CONF = "expandable_segments:True"


def _tm_say(row):
    print(json.dumps({"phase": "train_mesh", **row}), flush=True)


def _tm_sha(t):
    import hashlib
    import torch
    return hashlib.sha256(t.detach().cpu().contiguous().view(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest()[:16]


def _tm_batch(np, cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return batch


def _tm_expected(torch, np, model, tc, params, batch, k_rows, model_axis):
    """The one-device computation of a mesh step on this global batch, on
    the card: (loss, gradients in flatten order, grad_norm).  Where a MoE
    routes each row part alone (the reference's ``shard_map``, on a mesh
    with a ``model`` axis), the mean over the parts of the one-device
    step on each part's rows, the reported loss carrying the first part's
    aux loss; on a mesh without one, the one-device step (it routes the
    whole microbatch)."""
    from repro_torch.models.common import tree_flatten, tree_unflatten
    from repro_torch.training import global_norm
    from repro_torch.training.train import _accumulate
    n = tc.microbatches
    b = next(iter(batch.values())).shape[0]
    dev = lambda x: {k: torch.as_tensor(v, device=DEVICE)
                     for k, v in x.items()}

    def rows(d, i=None):
        per = b // (n * k_rows)
        mbs = range(n) if i is None else (i,)
        return {k: np.concatenate([v[j * (b // n) + d * per:
                                     j * (b // n) + (d + 1) * per]
                                   for j in mbs]) for k, v in batch.items()}
    if k_rows == 1 or not (model.cfg.n_experts and model_axis):
        loss, grads = _accumulate(model, tc, params, dev(batch))
        grads = [g.float() for g in grads]
    else:
        parts = [_accumulate(model, tc, params, dev(rows(d)))
                 for d in range(k_rows)]
        loss = sum(p[0] for p in parts) / k_rows
        grads = [sum(g.float() for g in gs) / k_rows
                 for gs in zip(*(p[1] for p in parts))]
        with torch.no_grad():
            for i in range(n):
                aux = [float(model.forward(params, dev(rows(d, i)))[1][
                    "aux_loss"]) for d in range(k_rows)]
                loss = loss + (aux[0] - sum(aux) / k_rows) / n
    paths = [p for p, _ in tree_flatten(params)]
    return float(loss), grads, float(global_norm(tree_unflatten(paths,
                                                                grads)))


def _tm_capture(check):
    """Patch the optimizer to hand each step's reduced gradients (in
    flatten order) to ``check`` before the update; returns a function
    that undoes the patch.  Nothing is copied: a copy of every gradient
    would add its bytes to the rank's peak."""
    import repro_torch.training.optim as optim
    from repro_torch.models.common import tree_flatten
    real = optim.adamw_update

    def capture(cfg, p, grads, opt, inplace=False, grad_norm=None):
        check([g for _, g in tree_flatten(grads)])
        return real(cfg, p, grads, opt, inplace=inplace, grad_norm=grad_norm)
    optim.adamw_update = capture
    return lambda: setattr(optim, "adamw_update", real)


def _tm_worst(paths, got, want, layout=None):
    """(the largest max|got - want| / max(1, max|want|) over the leaves,
    its leaf); ``want`` whole leaves cut to this rank's part where
    ``layout`` says the rank holds one, moved to the card leaf by
    leaf."""
    worst, leaf = 0.0, None
    for path, g, w in zip(paths, got, want):
        if layout is not None and w.shape != g.shape:
            w = layout.local("params/" + path, w)
        w = w.to(g.device)
        r = float((g.float() - w.float()).abs().max()) / max(
            1.0, float(w.abs().max()))
        if r >= worst:
            worst, leaf = r, path
    return worst, leaf


def _tm_placed(model, live):
    """The bytes of a rank's train state on ``live`` under the reference's
    placement (``launch.cells.placements`` of the whole state)."""
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.cells import placed_bytes, placements
    from repro_torch.models.common import tree_flatten
    from repro_torch.training import init_state, state_axes
    whole = init_state(model, 0, "meta")
    with use_mesh(live):
        axes = state_axes(model)
    specs = dict(tree_flatten(placements(live, axes, whole)))
    return sum(placed_bytes(live, t, specs[p])
               for p, t in tree_flatten(whole))


def _tm_held(state):
    """The bytes of the state this rank holds."""
    from repro_torch.models.common import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(state))


def _tm_collectives(torch):
    """Time the mesh step's gathers (``dist.collectives._gather_whole``:
    the gathered whole's bytes) and gradient reduces (``reduce_scatter``
    where it sums: the f32 whole's bytes), each call between two device
    syncs; returns (the totals, a function that undoes the patch)."""
    import repro_torch.dist.collectives as col
    rec = {"gathers": 0, "gather_bytes": 0, "gather_ms": 0.0,
           "reduces": 0, "reduce_bytes": 0, "reduce_ms": 0.0}
    real_gather, real_reduce = col._gather_whole, col.reduce_scatter

    def timed(kind, fn, nbytes):
        def run(x, plan, mesh):
            if kind == "reduce" and mesh.split(plan.reduce)[0] == 1:
                return fn(x, plan, mesh)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(x, plan, mesh)
            torch.cuda.synchronize()
            rec[kind + "s"] += 1
            rec[kind + "_bytes"] += nbytes(x, out)
            rec[kind + "_ms"] += (time.perf_counter() - t) * 1e3
            return out
        return run
    col._gather_whole = timed("gather", real_gather,
                              lambda x, out: out.numel() * out.element_size())
    col.reduce_scatter = timed("reduce", real_reduce,
                               lambda x, out: x.numel() * 4)

    def undo():
        col._gather_whole, col.reduce_scatter = real_gather, real_reduce
    return rec, undo


def _tm_model_reduces(torch):
    """Time the split compute's collectives over ``model`` (the sums and
    maxes of ``dist.collectives._summed`` over ``model`` outside the
    gradient reduce), each call between two device syncs; returns (the
    totals, a function that undoes the patch)."""
    import repro_torch.dist.collectives as col
    rec = {"model_reduces": 0, "model_reduce_bytes": 0,
           "model_reduce_ms": 0.0}
    real_summed, real_reduce = col._summed, col.reduce_scatter
    inside = []

    def summed(x, axes, mesh, op=None):
        if inside or mesh.canonical(axes) != ("model",) or \
                x.device.type == "meta":
            return real_summed(x, axes, mesh, op)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_summed(x, axes, mesh, op)
        torch.cuda.synchronize()
        rec["model_reduces"] += 1
        rec["model_reduce_bytes"] += x.numel() * x.element_size()
        rec["model_reduce_ms"] += (time.perf_counter() - t) * 1e3
        return out

    def reduce(*args):
        inside.append(True)
        try:
            return real_reduce(*args)
        finally:
            inside.pop()
    col._summed, col.reduce_scatter = summed, reduce

    def undo():
        col._summed, col.reduce_scatter = real_summed, real_reduce
    return rec, undo


def _tm_smoke(torch, np, live, arch, over, tc_over):
    """(tm1) one case on this rank: three steps, each against the
    one-device computation from the same gathered state."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.common import tree_flatten, tree_unflatten
    from repro_torch.training import (OptConfig, TrainConfig, adamw_init,
                                      make_jitted_train_step)
    from repro_torch.training.train import local_batch, shard_state
    model = get_model(dataclasses.replace(get_config(arch, smoke=True),
                                          dtype="float32", **over))
    tc = TrainConfig(opt=OptConfig(lr=1e-3, eps=1e-6, total_steps=10,
                                   warmup_steps=0), **tc_over)
    params = shard_state(model, model.init(0, DEVICE), live)
    state = {"params": params, "opt": adamw_init(params)}
    step = make_jitted_train_step(model, tc, mesh=live)
    layout = step.layout
    k_rows = live.split(("pod", "data"))[0]
    row = {"loss_err": [], "loss_limit": [], "grad_err_ratio": [],
           "grad_leaf": [], "norm_rel_err": [], "param_sha": [],
           "loss_bits": [], "norm_bits": [],
           "state_bytes_rank": _tm_held(state),
           "placed_bytes": _tm_placed(model, live)}
    seen, want_grads = [], []
    undo = _tm_capture(lambda got: seen.append(_tm_worst(
        paths, got, want_grads, layout)))
    try:
        for s in range(TM_STEPS):
            gb = _tm_batch(np, model.cfg, *TM1_BATCH, seed=s + 1)
            paths = [p for p, _ in tree_flatten(state["params"])]
            whole = tree_unflatten(paths, layout.gathered(
                {"params": state["params"]}))
            want_loss, want_grads[:], want_norm = _tm_expected(
                torch, np, model, tc, whole, gb, k_rows,
                "model" in live.spec.names)
            del whole
            state, met = step(state, local_batch(gb, tc.microbatches, live))
            worst, leaf = seen[-1]
            loss, norm = float(met["loss"]), float(met["grad_norm"])
            row["loss_err"].append(abs(loss - want_loss))
            row["loss_limit"].append(TRAIN_LOSS_TOL * max(1.0,
                                                          abs(want_loss)))
            row["grad_err_ratio"].append(worst)
            row["grad_leaf"].append(leaf)
            row["norm_rel_err"].append(abs(norm - want_norm) / want_norm)
            # the state gathered whole: the same on every rank only if
            # every replica of every part is
            row["param_sha"].append({
                p: _tm_sha(t) for (p, _), t in zip(
                    tree_flatten(state), layout.gathered(state))})
            row["loss_bits"].append(loss)
            row["norm_bits"].append(norm)
    finally:
        undo()
    return row


def _tm_one_device_keep(torch, model, tc, batch, layout):
    """(tm3) One device on this rank (the other rank waits): the loss,
    grad_norm, and on the host the gradients and the params after one
    in-place step, each leaf cut to this rank's part."""
    from repro_torch.models.common import tree_flatten, tree_unflatten
    from repro_torch.training import adamw_init, adamw_update, global_norm
    from repro_torch.training.train import _accumulate
    params = model.init(0, DEVICE)
    loss, grads = _accumulate(model, tc, params, batch)
    paths = [p for p, _ in tree_flatten(params)]
    norm = float(global_norm(tree_unflatten(paths, grads)))
    opt = adamw_init(params)
    adamw_update(tc.opt, params, tree_unflatten(paths, grads), opt,
                 inplace=True)
    del opt

    def mine(path, t):
        return layout.local("params/" + path, t).detach().to("cpu",
                                                             copy=True)
    keep = {p: (mine(p, g), mine(p, t))
            for (p, t), g in zip(tree_flatten(params), grads)}
    del params, grads
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return float(loss), norm, keep


def _tm_mixtral(torch, np, live, rank):
    """(tm3) mixtral-8x22b at its widths, expert-parallel on model=2."""
    import dataclasses
    import gc
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import get_model
    from repro_torch.models.common import tree_flatten
    from repro_torch.training import (OptConfig, TrainConfig, init_state,
                                      make_jitted_train_step)
    from repro_torch.training.train import StateLayout
    b, s, layers = TM3
    cfg = dataclasses.replace(get_config("mixtral-8x22b"), num_layers=layers,
                              dtype="float32")
    model = get_model(cfg)
    tc = TrainConfig(opt=OptConfig(lr=TM3_LR, total_steps=10,
                                   warmup_steps=0))
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in SyntheticTokens(
        DataConfig(vocab=cfg.vocab, global_batch=b, seq_len=s)).batch(
        0).items()}
    layout = StateLayout(model, live)
    t0 = time.perf_counter()
    want = None
    for r in range(live.spec.size):       # one device, one rank at a time
        if r == rank:
            torch.cuda.reset_peak_memory_stats()
            want = _tm_one_device_keep(torch, model, tc, batch, layout)
            one_peak = torch.cuda.max_memory_allocated() / 1e9
        dist.barrier()
    one_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    state = init_state(model, 0, DEVICE, mesh=live)
    held = _tm_held(state)
    step = make_jitted_train_step(model, tc, mesh=live)
    want_loss, want_norm, keep = want
    paths = [p for p, _ in tree_flatten(state["params"])]
    seen = []
    undo = _tm_capture(lambda got: seen.append(_tm_worst(
        paths, got, [keep[p][0] for p in paths])))
    coll, undo_coll = _tm_collectives(torch)
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t1) * 1e3
    finally:
        undo()
        undo_coll()
    peak = torch.cuda.max_memory_allocated() / 1e9
    (grad_worst, grad_leaf), = seen
    param_worst, param_leaf = _tm_worst(
        paths, [t for _, t in tree_flatten(state["params"])],
        [keep[p][1] for p in paths])
    loss, norm = float(met["loss"]), float(met["grad_norm"])
    n_params = sum(t.numel() for _, t in tree_flatten(model.init(0, "meta")))
    del state, seen, keep
    gc.collect()
    torch.cuda.empty_cache()
    return {"case": "tm3", "arch": "mixtral-8x22b", "mesh": "model=2",
            "layers": layers, "tokens": b * s, "params": n_params,
            "loss": loss, "loss_err": abs(loss - want_loss),
            "loss_limit": TRAIN_LOSS_TOL * max(1.0, abs(want_loss)),
            "grad_err_ratio": grad_worst, "grad_leaf": grad_leaf,
            "norm_rel_err": abs(norm - want_norm) / want_norm,
            "param_err_ratio": param_worst, "param_leaf": param_leaf,
            "state_bytes_rank": held, "placed_bytes": _tm_placed(model, live),
            "state_gb_rank": held / 1e9, "peak_gb_rank": peak,
            "one_device_peak_gb": one_peak, "one_device_s": one_s,
            "step_ms": step_ms, **coll}


def _tm_minicpm(torch, np, live, rank):
    """(tm2) minicpm-2b at its widths on data=2: 2 steps of 4 x 512."""
    import dataclasses
    import gc
    import statistics as st
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import get_model
    from repro_torch.models.common import tree_flatten, tree_leaves, \
        tree_unflatten
    from repro_torch.training import (OptConfig, TrainConfig, global_norm,
                                      init_state, make_jitted_train_step)
    from repro_torch.training.train import _accumulate, rank_rows
    b, s, steps, layers = TM2
    cfg = dataclasses.replace(get_config("minicpm-2b"), num_layers=layers)
    model = get_model(cfg)
    tc = TrainConfig(opt=OptConfig(lr=TRAIN_LR, total_steps=steps,
                                   warmup_steps=steps,
                                   schedule=cfg.lr_schedule))
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, global_batch=b,
                                      seq_len=s, seed=0))
    want = None
    if rank == 0:                         # one device; the other rank waits
        params = model.init(0, DEVICE)
        whole = {k: torch.as_tensor(v, device=DEVICE)
                 for k, v in data.batch(0).items()}
        loss, grads = _accumulate(model, tc, params, whole)
        paths = [p for p, _ in tree_flatten(params)]
        want = (float(loss), float(global_norm(tree_unflatten(paths,
                                                             grads))))
        del params, grads, whole
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(model, 0, DEVICE, mesh=live)
    n_params = sum(t.numel() for t in tree_leaves(model.init(0, "meta")))
    held = _tm_held(state)
    step = make_jitted_train_step(model, tc, mesh=live)
    rows = rank_rows(b, 1, live)
    losses, norms, ms, coll = [], [], [], None
    for i in range(steps):
        batch = {k: torch.as_tensor(v, device=DEVICE)
                 for k, v in data.batch_rows(i, rows).items()}
        # the first step's gathers and reduces timed one call at a time;
        # the later steps' times are the step's own
        if i == 0:
            coll, undo = _tm_collectives(torch)
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            state, met = step(state, batch)
            torch.cuda.synchronize()
        finally:
            if i == 0:
                undo()
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    del state
    gc.collect()
    torch.cuda.empty_cache()
    step_ms = st.median(ms[1:])
    row = {"case": "tm2", "arch": "minicpm-2b", "mesh": "data=2",
           "layers": layers, "params": n_params, "batch": [b, s],
           "losses": losses, "grad_norms": norms, "step_ms": ms,
           "step_ms_median": step_ms,
           "tokens_per_s": b * s / (step_ms / 1e3),
           "state_bytes_rank": held, "placed_bytes": _tm_placed(model, live),
           "state_gb_rank": held / 1e9, "peak_gb_rank": peak, **coll}
    if want is not None:
        row.update(one_device_loss=want[0], one_device_grad_norm=want[1],
                   loss_err=abs(losses[0] - want[0]),
                   loss_limit=TM2_LOSS_TOL * max(1.0, abs(want[0])),
                   norm_rel_err=abs(norms[0] - want[1]) / want[1],
                   norm_limit=TM2_NORM_TOL)
    return row


def _tm_minicpm_model(torch, np, live, rank):
    """(tm4) minicpm-2b at its widths on model=2, its compute split over
    ``model``: 2 steps of 4 x 512, step 1 against one device."""
    import dataclasses
    import gc
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import get_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import (OptConfig, TrainConfig, init_state,
                                      make_jitted_train_step)
    b, s, steps, layers = TM4
    cfg = dataclasses.replace(get_config("minicpm-2b"), num_layers=layers)
    model = get_model(cfg)
    tc = TrainConfig(opt=OptConfig(lr=TRAIN_LR, total_steps=steps,
                                   warmup_steps=steps,
                                   schedule=cfg.lr_schedule))
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, global_batch=b,
                                      seq_len=s, seed=0))
    want, one_peak, one_ms = None, None, None
    if rank == 0:                         # one device; the other rank waits
        # its peak over what the mesh rank's covers: the state (params
        # and both AdamW moments) and a whole step
        torch.cuda.reset_peak_memory_stats()
        one = init_state(model, 0, DEVICE)
        one_step = make_jitted_train_step(model, tc)
        whole = {k: torch.as_tensor(v, device=DEVICE)
                 for k, v in data.batch(0).items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        one, met = one_step(one, whole)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t) * 1e3
        want = (float(met["loss"]), float(met["grad_norm"]))
        one_peak = torch.cuda.max_memory_allocated() / 1e9
        del one, one_step, whole, met
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(model, 0, DEVICE, mesh=live)
    n_params = sum(t.numel() for t in tree_leaves(model.init(0, "meta")))
    held = _tm_held(state)
    step = make_jitted_train_step(model, tc, mesh=live)
    losses, norms, ms, coll = [], [], [], {}
    for i in range(steps):
        # every row on every model rank
        batch = {k: torch.as_tensor(v, device=DEVICE)
                 for k, v in data.batch(i).items()}
        # the first step's collectives timed one call at a time; the
        # second step's time is the step's own
        if i == 0:
            coll, undo = _tm_collectives(torch)
            split, undo_split = _tm_model_reduces(torch)
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            state, met = step(state, batch)
            torch.cuda.synchronize()
        finally:
            if i == 0:
                undo_split()
                undo()
                coll.update(split)
        ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    cut = list(step.cut_leaves)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    row = {"case": "tm4", "arch": "minicpm-2b", "mesh": "model=2",
           "layers": layers, "params": n_params, "batch": [b, s],
           "cut_leaves": cut, "losses": losses, "grad_norms": norms,
           "step_ms": ms, "step2_ms": ms[-1],
           "tokens_per_s": b * s / (ms[-1] / 1e3),
           "state_bytes_rank": held, "placed_bytes": _tm_placed(model, live),
           "state_gb_rank": held / 1e9, "peak_gb_rank": peak, **coll}
    if want is not None:
        row.update(one_device_loss=want[0], one_device_grad_norm=want[1],
                   one_device_peak_gb=one_peak, one_device_step_ms=one_ms,
                   loss_err=abs(losses[0] - want[0]),
                   loss_limit=TM2_LOSS_TOL * max(1.0, abs(want[0])),
                   norm_rel_err=abs(norms[0] - want[1]) / want[1],
                   norm_limit=TM2_NORM_TOL)
    return row


def train_mesh_rank_main(rank: int, world: int, work: str) -> int:
    """One rank of a train_mesh group: (tm1)'s cases for this group size,
    then with two ranks (tm3), (tm2) and (tm4); one JSON row a case on stdout,
    checked by the parent.  Every rank makes the same calls in the same
    order (the collectives pair up across ranks)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.dist import MeshSpec
    from repro_torch.dist.collectives import LiveMesh, destroy_process_group
    torch.backends.cudnn.deterministic = True
    dist.init_process_group(
        "gloo", init_method=f"file://{work}/rendezvous{world}", rank=rank,
        world_size=world)
    try:
        meshes = {}
        for case, mesh, arch, over, tc_over in TM1[world]:
            if mesh not in meshes:
                meshes[mesh] = LiveMesh(MeshSpec.parse(mesh),
                                        torch.device(DEVICE))
            t0 = time.perf_counter()
            row = _tm_smoke(torch, np, meshes[mesh], arch, over, tc_over)
            _tm_say({"case": case, "mesh": mesh, "arch": arch,
                     "tp_psum": over.get("tp_psum", False), **tc_over,
                     "rank": rank, "seconds": time.perf_counter() - t0,
                     **row})
        if world == 2:
            for mesh, fn in (("model=2", _tm_mixtral),
                             ("data=2", _tm_minicpm),
                             ("model=2", _tm_minicpm_model)):
                t0 = time.perf_counter()
                live = meshes.get(mesh) or LiveMesh(MeshSpec.parse(mesh),
                                                    torch.device(DEVICE))
                row = fn(torch, np, live, rank)
                _tm_say({**row, "rank": rank,
                         "seconds": time.perf_counter() - t0})
    finally:
        destroy_process_group()
    return 0


def _tm_ranks(world: int, work: str):
    """Run a group of ``world`` train_mesh rank processes on the card to
    their end: (their exit codes, their rows)."""
    import threading
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF=TM_ALLOC_CONF)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--train-mesh-rank",
         str(r), str(world), work], cwd=ROOT, stdout=subprocess.PIPE,
        text=True, env=env) for r in range(world)]
    timers = [threading.Timer(TM_RANK_TIMEOUT_S[world], p.kill)
              for p in procs]
    for t in timers:
        t.start()
    rows = []
    try:
        for p in procs:
            out, _ = p.communicate()
            rows += [json.loads(line) for line in out.splitlines()
                     if line.startswith("{")]
    finally:
        for t in timers:
            t.cancel()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], rows


def _tm_problems(world, rows):
    """Each row within its limits; the replicas' state and metrics the
    same bits on every rank of a case."""
    problems = []
    by_case = collections.defaultdict(list)
    for row in rows:
        by_case[(row["case"], row["mesh"], row["arch"])].append(row)
    for key, group in by_case.items():
        if len(group) != world:
            problems.append(f"train_mesh {key}: {len(group)} of {world} "
                            f"ranks reported")
        # (tm1) rows hold a list a step; (tm2)'s rank 1 holds no reference
        listed = lambda v: v if isinstance(v, list) else [v]
        for row in group:
            errs = listed(row.get("loss_err", 0.0))
            lims = listed(row.get("loss_limit", float("inf")))
            grads = listed(row.get("grad_err_ratio", 0.0))
            norms = listed(row.get("norm_rel_err", 0.0))
            norm_lim = row.get("norm_limit", TRAIN_NORM_TOL)
            bad = (any(e > lim for e, lim in zip(errs, lims))
                   or any(g > TRAIN_GRAD_TOL for g in grads)
                   or any(n > norm_lim for n in norms)
                   or row.get("param_err_ratio", 0.0) > TM3_PARAM_TOL)
            if bad:
                problems.append(
                    f"train_mesh {key} rank {row['rank']}: loss err {errs} "
                    f"(limits {lims}), gradient err {grads} x max(1, "
                    f"max|g|), grad_norm rel err {norms} (limit "
                    f"{norm_lim}), params {row.get('param_err_ratio')}")
        for row in group:
            if row.get("state_bytes_rank") != row.get("placed_bytes"):
                problems.append(
                    f"train_mesh {key} rank {row['rank']}: the state a rank "
                    f"holds is {row.get('state_bytes_rank')} bytes, the "
                    f"placed bytes {row.get('placed_bytes')}")
        for field in ("param_sha", "loss_bits", "norm_bits", "losses",
                      "grad_norms", "loss"):
            vals = {json.dumps(r.get(field), sort_keys=True) for r in group}
            if len(vals) > 1:
                problems.append(f"train_mesh {key}: {field} differs "
                                f"across ranks")
        if key[0] in ("tm2", "tm4"):
            losses = group[0]["losses"]
            if not all(math.isfinite(x) for x in losses):
                problems.append(f"train_mesh {key[0]}: losses {losses}")
        if key[0] == "tm4" and not (
                group[0].get("model_reduces", 0) > 0
                and "embed" in group[0].get("cut_leaves", ())
                and any("/wq" in p for p in group[0]["cut_leaves"])):
            problems.append("train_mesh tm4: the step did not split its "
                            "heads and vocab over model")
        if key[0] == "tm4" and "loss_err" not in \
                {k for r in group for k in r}:
            problems.append("train_mesh tm4: no one-device reference")
    return problems


def train_mesh_main() -> int:
    """The train_mesh phase, in its own process: a group of four rank
    processes on the card ((tm1) on data=2,model=2), then a group of two
    ((tm1) on model=2 and data=2, (tm3), (tm2), (tm4)), over gloo."""
    import shutil
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke --train-mesh: no CUDA device", file=sys.stderr)
        return 2
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("TF32 is on; the f32 comparisons need it off")
    shutil.rmtree(TRAIN_MESH_DIR, ignore_errors=True)
    os.makedirs(TRAIN_MESH_DIR)
    problems = []
    # a row a rank for each (tm1) case, and for (tm3) and (tm2) with two
    expected = {w: (len(TM1[w]) + (3 if w == 2 else 0)) * w for w in TM1}
    for world in (4, 2):
        t0 = time.perf_counter()
        rcs, rows = _tm_ranks(world, TRAIN_MESH_DIR)
        if rcs != [0] * world or len(rows) != expected[world]:
            problems.append(f"train_mesh: {world} ranks exited {rcs} with "
                            f"{len(rows)} rows")
        problems += _tm_problems(world, rows)
        for row in rows:
            row.pop("param_sha", None)
            emit(row)
        emit({"phase": "train_mesh", "case": "group_done", "ranks": world,
              "rcs": rcs, "seconds": time.perf_counter() - t0})
    shutil.rmtree(TRAIN_MESH_DIR, ignore_errors=True)
    if problems:
        raise SystemExit("train_mesh phase failed: " + "; ".join(problems))
    return 0


def phase_train_mesh():
    """The train_mesh phase in its child process."""
    return phase_child("--train-mesh", TRAIN_MESH_TIMEOUT_S, "train_mesh")


# ---------------------------------------------------------------------------
# The dryrun phase (``python3 chip_smoke.py --dryrun`` runs it alone)
# ---------------------------------------------------------------------------
#: (d1): the reference's one committed dry-run cell (arch, shape, mesh),
#: counted at rank 0 of the production mesh's fake group on fake cuda
#: tensors.  It and (d3) run in a process of their own
#: (``--dryrun-cell``): the full script starts it after the build and
#: collects it after the train_mesh phase (they work on the host, beside
#: the phases' work on the card).
DRY_CELL = ("qwen2.5-14b", "train_4k", "single")
#: The reference's committed record of (d1)'s cell (read, never written),
#: printed beside the port's.
DRY_REFERENCE = ("benchmarks", "artifacts", "dryrun",
                 "qwen2.5-14b__train_4k__single.json")
#: (d2): minicpm-2b at its published widths cut to DRY_D2[0] layers, one
#: train step of DRY_D2[1] x DRY_D2[2] tokens on one device, counted on
#: real cuda tensors here and on fake cuda (and, its FLOPs, fake cpu)
#: ones beside (d1); median ms of DRY_D2_RUNS steps after one warm-up.
DRY_D2 = (2, 1, 512)
DRY_D2_RUNS = 3
#: (d3): minicpm-2b cut to DRY_D3[0] layers, DRY_D3[1] microbatches of
#: one DRY_D3[2]-token row: the counts weighed from the dry-run's traced
#: depths against the step traced whole, on fake cuda tensors.
DRY_D3 = (4, 2, 512)
#: The phase's time on the card should stay under DRY_BUDGET_S (it is
#: reported, not enforced); the watchdog kills (d1)'s process
#: DRY_CELL_TIMEOUT_S after the script starts to wait for it.
DRY_BUDGET_S = 45
DRY_CELL_TIMEOUT_S = 120
#: (d1) against the reference's committed record, since the mesh step
#: splits its compute over ``model``: FLOPs a rank at most this many
#: times the reference's ``flops_per_device``, and a
#: ``useful_flops_ratio`` of at least DRY_D1_USEFUL (0.046 before).
DRY_D1_FLOPS_OVER_REF = 1.25
DRY_D1_USEFUL = 0.55
#: (d4): the qwen2.5-14b x decode_32k x single cell, the partitioned
#: serving program, at rank 0 of the same fake group; the reference's
#: count of the cell (its dry-run, ``python -m repro.launch.dryrun
#: --arch qwen2.5-14b --shape decode_32k``: FLOPs a device, argument
#: bytes), to which the port's FLOPs a rank are held within
#: DRY_D1_FLOPS_OVER_REF and its argument bytes equal.
DRY_D4_CELL = ("qwen2.5-14b", "decode_32k", "single")
DRY_D4_REFERENCE = {"flops_per_device": 30_096_752_640,
                    "argument_size_in_bytes": 3_454_066_752}
_DRY_TERMS = ("compute_s", "memory_s", "collective_s", "step_time_bound_s",
              "roofline_fraction", "useful_flops_ratio")


def _dry_counts(cost):
    """The counts the dry-run holds equal: FLOPs, HBM bytes and the
    collective bytes by kind."""
    return {"flops": cost.flops, "hbm_bytes": cost.hbm_bytes,
            "collective_bytes": dict(cost.collective_bytes)}


def dryrun_cell_main() -> int:
    """(d2)'s fake half, (d3), then (d1), in their own process (they
    trace on the host, on fake tensors): a JSON row each."""
    import torch
    from repro_torch.launch import cells
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import CHIP_HBM_BYTES, \
        production_mesh_spec
    if not torch.cuda.is_available():
        print("chip_smoke --dryrun-cell: no CUDA device", file=sys.stderr)
        return 2
    # host work beside the phases on the card: yield the cores to them
    os.nice(10)
    torch.set_num_threads(1)
    print(json.dumps(_dry_d2_fake()), flush=True)
    print(json.dumps(_dry_d3()), flush=True)
    arch, shape, kind = DRY_CELL
    spec = production_mesh_spec(multi_pod=kind == "multi")
    t0 = time.perf_counter()
    with cells.dry_group(spec, 0, "cuda") as live:
        rec = run_cell(arch, shape, kind, None, device="cuda", mesh=live)
    args = rec.get("memory_analysis", {}).get("argument_size_in_bytes", 0)
    with open(os.path.join(ROOT, *DRY_REFERENCE)) as f:
        ref = json.load(f)
    print(json.dumps({"phase": "dryrun", "case": "d1", **rec,
                      "cuda_initialized": torch.cuda.is_initialized(),
                      "chip_hbm_bytes": CHIP_HBM_BYTES,
                      "argument_over_chip_hbm": args / CHIP_HBM_BYTES,
                      "reference": {k: ref.get(k) for k in (
                          "memory_analysis", "bytes_per_device",
                          "collective_bytes_per_device", "flops_per_device",
                          "bottleneck", "step_time_bound_s")},
                      "seconds": time.perf_counter() - t0}), flush=True)
    arch, shape, kind = DRY_D4_CELL
    t0 = time.perf_counter()
    with cells.dry_group(spec, 0, "cuda") as live:
        rec = run_cell(arch, shape, kind, None, device="cuda", mesh=live)
    print(json.dumps({"phase": "dryrun", "case": "d4", **rec,
                      "reference": DRY_D4_REFERENCE,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


def _dry_d4_problems(row) -> list:
    if row is None:
        return ["dryrun d4: no record"]
    problems = []
    if row.get("status") != "ok" or row.get("device") != "cuda" \
            or row.get("chips") != 256 or row.get("rank") != 0:
        problems.append(f"dryrun d4: status {row.get('status')} on "
                        f"{row.get('device')}, {row.get('chips')} chips, "
                        f"rank {row.get('rank')}")
    args = row.get("memory_analysis", {}).get("argument_size_in_bytes")
    want = DRY_D4_REFERENCE["argument_size_in_bytes"]
    if not args == row.get("argument_size_if_placed") == want:
        problems.append(f"dryrun d4: {args} argument bytes a rank, "
                        f"{row.get('argument_size_if_placed')} placed, "
                        f"the reference's {want}")
    flops, ref = row.get("flops_per_device"), \
        DRY_D4_REFERENCE["flops_per_device"]
    if not isinstance(flops, (int, float)) or not \
            0 < flops <= DRY_D1_FLOPS_OVER_REF * ref:
        problems.append(f"dryrun d4: {flops} FLOPs a rank, over "
                        f"{DRY_D1_FLOPS_OVER_REF} x the reference's {ref}")
    return problems


def _dry_d1_problems(row) -> list:
    import math
    if row is None:
        return ["dryrun d1: no record"]
    problems = []
    if row.get("status") != "ok" or row.get("device") != "cuda" \
            or row.get("chips") != 256 or row.get("rank") != 0:
        problems.append(f"dryrun d1: status {row.get('status')} on "
                        f"{row.get('device')}, {row.get('chips')} chips, "
                        f"rank {row.get('rank')}")
    if not all(isinstance(row.get(k), (int, float))
               and math.isfinite(row[k]) and row[k] > 0
               for k in _DRY_TERMS + ("flops_per_device",
                                      "bytes_per_device")):
        problems.append("dryrun d1: a roofline term is not a positive "
                        "finite number")
    if row.get("bottleneck") not in ("compute", "memory", "collective"):
        problems.append(f"dryrun d1: bottleneck {row.get('bottleneck')}")
    args = row.get("memory_analysis", {}).get("argument_size_in_bytes")
    if args != row.get("argument_size_if_placed"):
        problems.append(f"dryrun d1: {args} argument bytes a rank, "
                        f"{row.get('argument_size_if_placed')} placed")
    if not row.get("traced") or row.get("depth") != {"layer": 48} \
            or row.get("microbatches") != 8:
        problems.append("dryrun d1: traced depths missing or the cell's "
                        "depth is not 48 layers x 8 microbatches")
    ref = (row.get("reference") or {}).get("flops_per_device")
    flops = row.get("flops_per_device")
    if not ref or not isinstance(flops, (int, float)) \
            or flops > DRY_D1_FLOPS_OVER_REF * ref:
        problems.append(f"dryrun d1: {flops} FLOPs a rank, over "
                        f"{DRY_D1_FLOPS_OVER_REF} x the reference's {ref}")
    if not row.get("useful_flops_ratio", 0) >= DRY_D1_USEFUL:
        problems.append(f"dryrun d1: useful_flops_ratio "
                        f"{row.get('useful_flops_ratio')} under "
                        f"{DRY_D1_USEFUL}")
    return problems


def _dry_d2_config():
    import dataclasses
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.training import TrainConfig
    layers, b, s = DRY_D2
    cfg = dataclasses.replace(get_config("minicpm-2b"), num_layers=layers)
    return cfg, ShapeSpec(f"train_{b}x{s}", s, b, "train"), \
        TrainConfig(microbatches=1)


def _dry_d2_fake():
    """(d2)'s fake half, on the host: the dry-run's count of the step
    (``lower_cell`` on fake cuda tensors), its FLOPs traced on fake cpu
    tensors, and the record's bound."""
    from repro_torch.launch import cells
    cfg, shape, tc = _dry_d2_config()
    fake = cells.lower_cell(cfg, shape, None, tc, device=DEVICE)
    cpu = cells.trace_program(cfg, shape, None, tc, device="cpu")
    rec = cells.analyze(fake, cfg, shape)
    return {"phase": "dryrun", "case": "d2_fake",
            "fake_cuda": _dry_counts(fake.cost), "fake_ops": fake.cost.ops,
            "fake_cpu_flops": cpu.cost.flops,
            "step_time_bound_s": rec["step_time_bound_s"],
            "bottleneck": rec["bottleneck"]}


def _dry_d2(torch, np):
    """(d2)'s real half, on the card: the step counted on real cuda
    tensors, and its ms (median of DRY_D2_RUNS after a warm-up)."""
    import statistics as st
    from repro_torch.launch.op_analysis import analyze_trace
    from repro_torch.models import get_model
    from repro_torch.training import init_state, make_jitted_train_step
    cfg, shape, tc = _dry_d2_config()
    model = get_model(cfg)
    state = init_state(model, 0, DEVICE)
    rng = np.random.default_rng(0)
    b, s = shape.global_batch, shape.seq_len
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (b, s),
                                             dtype=np.int32), device=DEVICE)
             for k in ("tokens", "labels")}
    step = make_jitted_train_step(model, tc, donate=True)
    step(state, batch)                  # eager, then captured
    torch.cuda.synchronize()
    # the body the graph records, run op by op (a replay issues no op)
    _, real = analyze_trace(step.eager, state, batch)
    torch.cuda.synchronize()
    ms = []
    for _ in range(DRY_D2_RUNS):
        t = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    del state
    torch.cuda.empty_cache()
    return {"phase": "dryrun", "case": "d2", "arch": "minicpm-2b",
            "layers": cfg.num_layers, "batch": [b, s],
            "real": _dry_counts(real.cost), "real_ops": real.cost.ops,
            "step_ms": ms, "step_ms_median": st.median(ms)}


def _dry_d2_join(real, fake) -> list:
    """Complete (d2)'s row ``real`` from the fake half's row; its
    problems."""
    if fake is None:
        return ["dryrun d2: no fake count"]
    real.update({k: fake[k] for k in ("fake_cuda", "fake_ops",
                                      "fake_cpu_flops", "step_time_bound_s",
                                      "bottleneck")})
    real["measured_over_bound"] = (real["step_ms_median"] / 1e3
                                   / fake["step_time_bound_s"])
    problems = []
    if real["real"] != real["fake_cuda"]:
        problems.append("dryrun d2: real and fake cuda counts differ")
    if real["fake_cpu_flops"] != real["real"]["flops"]:
        problems.append("dryrun d2: fake cpu FLOPs differ from the real "
                        "step's")
    return problems


def _dry_d3():
    """(d3): the weighing of traced depths against a whole trace, on
    fake cuda tensors."""
    import dataclasses
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import cells
    from repro_torch.training import TrainConfig
    layers, n, s = DRY_D3
    cfg = dataclasses.replace(get_config("minicpm-2b"), num_layers=layers)
    shape = ShapeSpec(f"train_{n}x{s}", s, n, "train")
    tc = TrainConfig(microbatches=n)
    t0 = time.perf_counter()
    weighed = cells.lower_cell(cfg, shape, None, tc, device=DEVICE)
    t1 = time.perf_counter()
    whole = cells.trace_program(cfg, shape, None, tc, device=DEVICE)
    row = {"phase": "dryrun", "case": "d3", "arch": "minicpm-2b",
           "layers": layers, "microbatches": n, "tokens": s,
           "traced": weighed.traced, "weighed": _dry_counts(weighed.cost),
           "whole": _dry_counts(whole.cost), "weighed_s": t1 - t0,
           "whole_s": time.perf_counter() - t1}
    return row


def start_dryrun_cell():
    """Start (d2)'s fake half, (d3) and (d1) in a process of their own;
    they trace on the host and run beside the phases before the dryrun
    phase."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--dryrun-cell"], cwd=ROOT,
                            stdout=subprocess.PIPE, text=True)


def finish_dryrun_cell(cell, say, d2) -> list:
    """Wait for the cell's rows, complete (d2)'s row ``d2`` with its fake
    half, pass the rows to ``say`` and return their problems (the process
    is killed after DRY_CELL_TIMEOUT_S more seconds)."""
    try:
        out, _ = cell.communicate(timeout=DRY_CELL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        cell.kill()
        out, _ = cell.communicate()
    rows = {}
    for line in out.splitlines():
        try:
            row = json.loads(line)
        except ValueError:
            print(line, flush=True)
            continue
        rows[row.get("case")] = row
    problems = [] if cell.returncode == 0 else [
        f"dryrun --dryrun-cell exited {cell.returncode}"]
    problems += _dry_d2_join(d2, rows.pop("d2_fake", None))
    for row in [d2] + list(rows.values()):
        say(row)
    d3 = rows.get("d3")
    if d3 is None or d3["weighed"] != d3["whole"]:
        problems.append("dryrun d3: the weighed counts differ from the "
                        "whole trace's")
    return problems + _dry_d1_problems(rows.get("d1")) + \
        _dry_d4_problems(rows.get("d4"))


def dryrun_main() -> int:
    """The dryrun phase alone (``--dryrun``): the fake tracing in a
    process of its own while (d2)'s real step runs here."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke --dryrun: no CUDA device", file=sys.stderr)
        return 2
    say = lambda row: print(json.dumps(row), flush=True)
    cell = start_dryrun_cell()
    try:
        problems = _dry_phase(torch, np, cell, say)
    finally:
        if cell.poll() is None:
            cell.kill()
            cell.wait()
    if problems:
        raise SystemExit("dryrun phase failed: " + "; ".join(problems))
    return 0


def _dry_phase(torch, np, cell, say) -> list:
    """(d2)'s real half here, then the rest from ``cell``; each row to
    ``say``, then the phase's seconds."""
    t0 = time.perf_counter()
    d2 = _dry_d2(torch, np)
    t1 = time.perf_counter()
    problems = finish_dryrun_cell(cell, say, d2)
    say({"phase": "dryrun", "case": "time",
         "seconds": time.perf_counter() - t0,
         "d1_wait_s": time.perf_counter() - t1, "budget_s": DRY_BUDGET_S})
    return problems


def phase_dryrun(cell):
    """The dryrun phase, in this process: (d2)'s real step, then the
    fake traces ``cell`` (:func:`start_dryrun_cell`) has made beside the
    phases before it."""
    import numpy as np
    import torch
    return _dry_phase(torch, np, cell, emit)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("torch.backends.cuda.matmul.allow_tf32 is on; the "
                         "f32 comparisons need it off")
    phase_card(torch)
    phase_build()
    cell = start_dryrun_cell()
    try:
        engine_problems = (phase_engine() + phase_serve() + phase_shard()
                           + phase_mesh() + phase_train()
                           + phase_train_mesh() + phase_dryrun(cell))
    finally:
        if cell.poll() is None:
            cell.kill()
            cell.wait()
    errs = {}
    errs["fused_matmul"], errs["fast_act"], problems = phase_check(torch, np)
    problems += engine_problems
    errs["fused_matmul_q8"], more = phase_check_q8(torch, np)
    problems += more
    errs["decode_attention"], more = phase_check_decode(torch, np)
    problems += more
    exes, inputs, launches, per_model, more = phase_main(torch, np)
    problems += more
    launches_a, more = phase_path_a(torch, np, exes, inputs)
    problems += more
    dec_exes, dec_feeds, cuda_feeds, launches_b, more = phase_path_b(torch, np)
    problems += more
    totals = {k: launches[k] + launches_a[k] + launches_b[k] for k in KERNELS}
    problems += phase_program(torch, np, program_cases(
        torch, np, exes, inputs, dec_exes, cuda_feeds))
    problems += phase_split_counters(torch, np)
    problems += phase_runtime(torch, np, exes, inputs)
    problems += phase_cache(torch, np, exes, inputs)
    problems += phase_pool(torch, np, list(exes.values())
                           + list(dec_exes.values()))
    problems += phase_autotune(torch, np, exes, inputs)
    problems += phase_mixed(torch, np, exes, inputs)
    problems += phase_frontends(torch, np, exes, inputs, dec_exes, cuda_feeds)
    problems += phase_replay(torch, np)
    phase_time_models(torch, exes, inputs, per_model)
    phase_time_paths(torch, exes, inputs, dec_exes, dec_feeds, cuda_feeds)
    rows = phase_time_kernels(torch, np, exes)
    rows["fused_matmul_q8"] = phase_time_q8(torch, np, exes)
    rows["decode_attention"] = phase_time_decode(torch, dec_feeds)
    if problems:
        # Every phase ran and printed its findings; now fail.
        raise SystemExit("chip_smoke failed: " + "; ".join(problems))

    def summary(kernel, source, replaces, row, at):
        return {"name": kernel, "route": "cuda", "source": source,
                "replaces": replaces, "launches": totals[kernel],
                "max_abs_err": errs[kernel], "ms": row["ms"],
                "call_ms": row["call_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "at": at}

    mkn = lambda r: r["M"] * r["K"] * r["N"]
    fm_row = max(rows["fused_matmul"], key=mkn)
    q8_row = max(rows["fused_matmul_q8"], key=mkn)
    fa_row = max(rows["fast_act"], key=lambda r: int(np.prod(r["shape"])))
    da_row = max(rows["decode_attention"], key=lambda r: r["batch"])
    emit({"kernels": [
        summary("fused_matmul", "src/repro_torch/csrc/fused_matmul.cu",
                "src/repro/kernels/fused_matmul/kernel.py:109", fm_row,
                f"{fm_row['model']} {fm_row['node']} M={fm_row['M']} "
                f"K={fm_row['K']} N={fm_row['N']} {fm_row['layout']}"),
        summary("fast_act", "src/repro_torch/csrc/fast_act.cu",
                "src/repro/kernels/fast_act/kernel.py:61", fa_row,
                f"{fa_row['model']} softmax exp {fa_row['shape']}"),
        summary("fused_matmul_q8", "src/repro_torch/csrc/fused_matmul_q8.cu",
                "src/repro/kernels/fused_matmul/kernel.py:224", q8_row,
                f"{q8_row['model']} {q8_row['node']} M={q8_row['M']} "
                f"K={q8_row['K']} N={q8_row['N']} {q8_row['layout']} int8"),
        summary("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
                "src/repro/kernels/decode_attention/kernel.py:80", da_row,
                f"qwen2.5-14b B={da_row['batch']} H={DECODE['h']} "
                f"Hkv={DECODE['hkv']} D={DECODE['d']} S={DECODE['s']} "
                f"lengths {da_row['lengths']}"),
    ]})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--engine"]:
        sys.exit(engine_main())
    if sys.argv[1:] == ["--serve"]:
        sys.exit(serve_main())
    if sys.argv[1:] == ["--shard"]:
        sys.exit(shard_main())
    if sys.argv[1:2] == ["--shard-rank"]:
        sys.exit(shard_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                 sys.argv[4], sys.argv[5]))
    if sys.argv[1:] == ["--mesh"]:
        sys.exit(mesh_main())
    if sys.argv[1:] == ["--train"]:
        sys.exit(train_main())
    if sys.argv[1:] == ["--train-bits"]:
        sys.exit(train_bits_main())
    if sys.argv[1:] == ["--train-mesh"]:
        sys.exit(train_mesh_main())
    if sys.argv[1:] == ["--dryrun"]:
        sys.exit(dryrun_main())
    if sys.argv[1:] == ["--dryrun-cell"]:
        sys.exit(dryrun_cell_main())
    if sys.argv[1:2] == ["--train-mesh-rank"]:
        sys.exit(train_mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                      sys.argv[4]))
    if sys.argv[1:2] == ["--mesh-single"]:
        sys.exit(mesh_single_main(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                sys.argv[4]))
    try:
        rc = main()
    finally:
        if _OUT:
            save_log()
    sys.exit(rc)
