"""Multi-pod dry run of the port (port of ``repro.launch.dryrun``).

The reference lowers and compiles each step for a forced 512-device
host.  The port has no compile step: it traces one rank's step under
``FakeTensorMode`` on a fake world (the ``fake`` process-group backend:
every rank's tensors are fake and no data moves), with the counters of
``launch.hloanalysis`` (FLOPs, bytes accessed, collectives) and
``MemTracker`` (the peak of live device memory).  For one (arch × shape)
cell this:

  1. traces the full step on the single-pod (16, 16) mesh — proves the
     placements and gives the memory per device,
  2. repeats on the multi-pod (2, 16, 16) mesh — proves the 'pod' axis
     shards,
  3. traces L=1 and L=2 variants (single pod) whose difference is the
     per-layer FLOPs / bytes / collective bytes, composed into
     whole-model roofline terms.  The reference needs this because XLA
     counts a while body once; the port keeps it because a full-depth
     trace of the SSD chunk loop (Python) is slow, and the artifacts
     keep the reference's layout.

The step is the port's own (``launch.train``).  Under the ``tp``
profile every family's step splits over 'model' as GSPMD partitions
the reference's (``models.parallel``): a rank holds and computes its
share of every split leaf, and decode reads and writes its slice of the
K/V caches' sequence (``cache_defs``' layout; the hybrid's
``shared_kv`` too, and the encoder-decoder's ``cross_kv``, which it
reads only) with flash-decoding's combine, or its heads of the Mamba2
states, so its
FLOPs, bytes, collectives and peak are one rank's.  A cell's JSON names
the leaves that stay gathered (``tensor_parallel.gathered_leaves``: a
block whose heads 'model' does not divide, the kv projections where
ranks share kv heads, MoE widths 'model' does not divide, a Mamba2
block's fused ``in_proj`` and conv, sliced to a rank's columns) and,
for decode, whether 'model' splits the caches' sequence
(``tensor_parallel.kv_cache``, ``tensor_parallel.cross_kv_cache``) or
the SSM states' heads (``tensor_parallel.ssm_cache``).  The hybrid's
one-group and two-group variants and the encoder-decoder's one-layer
and two-layer ones (step 3) are traced with the split too.  Other
profiles gather
every parameter, so their FLOPs per device do not divide by 'model',
and a large architecture can exceed a card's memory: the dry run
reports that as it is (``exceeds_device_memory``), and skips nothing
for it.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k \\
      [--variant V] [--skip-multi] [--skip-roofline] [--update-roofline] \\
      [--out artifacts/dryrun_torch]
  python -m repro_torch.launch.dryrun --list        # the 40-cell matrix

With no process group the CLI opens a fake world of 512 ranks (the
counterpart of the reference's forced 512 host devices).  The fake
tensors and the meshes are "cuda" where ``torch.cuda.is_available()``
(no card memory is touched), else "cpu": a CPU-only torch cannot index
fake CUDA tensors.  The counts do not depend on it: the card tests hold
a cell's dict on "cuda" equal to its dict on "cpu".  A cell's traces
(single pod, multi pod, L1, L2) run at once in worker processes, as
many as the host has cores.

Hardware model for the roofline terms, per card: NVIDIA H100 80GB HBM3
(SXM) at 700 W, from NVIDIA's data sheet — figures, not measurements:
dense bf16 tensor-core peak 989e12 FLOP/s; HBM3 3.35e12 B/s; and a
collective bandwidth of 50e9 B/s, one 400 Gb/s NDR InfiniBand port per
GPU.  A (16, 16) mesh of 256 cards spans 32 eight-card nodes, so both
of its axes cross nodes; within a node NVLink gives 450e9 B/s per
direction, which no axis of these meshes stays inside.
"""
from __future__ import annotations

import argparse
import atexit
import dataclasses
import json
import math
import os
import time
import traceback
from types import SimpleNamespace

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import SHAPES, skip_reason
from repro_torch.launch.hloanalysis import StepCounter
from repro_torch.launch.mesh import (dp_axes_of, make_mesh_from_devices,
                                     make_production_mesh)
from repro_torch.launch.train import (_cache_placements, _profile,
                                      _seq_split, abstract_serve_args,
                                      abstract_train_args, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models.parallel import gathered_leaves, tp_layout

__all__ = ["PEAK_FLOPS", "HBM_BW", "COLL_BW", "DEVICE_MEMORY_BYTES",
           "VARIANTS", "run_cell", "start_worker_server", "stop_worker_server",
           "main"]

# NVIDIA H100 80GB HBM3 (SXM), 700 W, data-sheet figures (per card).
PEAK_FLOPS = 989e12      # dense bf16 tensor cores
HBM_BW = 3.35e12         # bytes/s, HBM3
COLL_BW = 50e9           # bytes/s: one 400 Gb/s NDR port per GPU
DEVICE_MEMORY_BYTES = 80e9

# §Perf hillclimb variants: config deltas applied over the baseline.
VARIANTS = {
    "baseline": {},
    "remat_dots": dict(remat_policy="dots"),
    "remat_none": dict(remat_policy="none"),
    "causal_skip": dict(attn_causal_unroll=True),
    "puredp": dict(sharding_profile="dp"),
    "puredp_nremat": dict(sharding_profile="dp", remat_policy="none"),
    "opt": dict(remat_policy="dots", attn_causal_unroll=True),
    "opt_nremat": dict(remat_policy="none", attn_causal_unroll=True),
    "zero3": dict(sharding_profile="zero3"),
    "zero3_dots": dict(sharding_profile="zero3", remat_policy="dots"),
    "zero3_nothing": dict(sharding_profile="zero3", remat_policy="nothing"),
    "kv8": dict(kv_cache_dtype="float8_e4m3fn"),
    "dots_chunk4k": dict(remat_policy="dots", loss_chunk=2048, attn_chunk=2048),
}


def _device_type() -> str:
    """The fake tensors' device type (see above)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _mesh(multi_pod: bool):
    if multi_pod:
        return make_production_mesh(multi_pod=True,
                                    device_type=_device_type())
    return make_mesh_from_devices(range(256), (16, 16), ("data", "model"),
                                  device_type=_device_type())


def _step_and_args(cfg, shape, mesh):
    """The step and a builder of its abstract arguments."""
    dp = dp_axes_of(mesh)
    if shape.kind == "train":
        return (make_train_step(cfg),
                lambda: abstract_train_args(cfg, shape, mesh, dp))
    step = make_prefill_step(cfg) if shape.kind == "prefill" \
        else make_decode_step(cfg)
    return step, lambda: abstract_serve_args(cfg, shape, mesh, dp)


def _local_leaves(tree) -> list:
    """This rank's tensors in a tree of tensors and DTensors."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _trace(cfg, shape, mesh):
    """One rank's step on ``mesh`` under ``FakeTensorMode``, counted:
    the reference's ``_compile`` keys, ``compile_s`` being the trace's
    seconds."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    step, build_args = _step_and_args(cfg, shape, mesh)
    with FakeTensorMode():
        args = build_args()
        arg_tensors = _local_leaves(args)
        tracker = MemTracker()
        tracker.track_external(*arg_tensors)
        t0 = time.perf_counter()
        with tracker, StepCounter() as counter:
            out = step(*args)
        dt = time.perf_counter() - t0
        out_bytes = _nbytes(_local_leaves(out))
    peak = sum(snap["Total"]
               for snap in tracker.get_tracker_snapshot("peak").values())
    arg_bytes = _nbytes(arg_tensors)
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": out_bytes,
           "temp_size_in_bytes": max(0, peak - arg_bytes),
           "alias_size_in_bytes": 0,
           "generated_code_size_in_bytes": 0}
    ca = counter.cost_analysis()
    return {
        "compile_s": round(dt, 2),
        "flops": ca["flops"],
        "bytes": ca["bytes accessed"],
        "memory": mem,
        "exceeds_device_memory": bool(
            arg_bytes + mem["temp_size_in_bytes"] > DEVICE_MEMORY_BYTES),
        "collectives": counter.collective_stats(),
        "unmatched_collectives": sorted(set(counter.unmatched)),
    }


def _layer_variants(cfg):
    """(cfg_L1, cfg_L2, units, tail_units) for per-layer delta extraction."""
    r = dataclasses.replace
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        groups = cfg.num_layers // k
        tail = cfg.num_layers - groups * k
        return (r(cfg, num_layers=k, unroll_layers=True),
                r(cfg, num_layers=2 * k, unroll_layers=True),
                groups, tail / k)
    if cfg.family == "encdec":
        return (r(cfg, encoder_layers=1, decoder_layers=1, unroll_layers=True),
                r(cfg, encoder_layers=2, decoder_layers=2, unroll_layers=True),
                cfg.encoder_layers, 0.0)
    return (r(cfg, num_layers=1, unroll_layers=True),
            r(cfg, num_layers=2, unroll_layers=True),
            cfg.num_layers, 0.0)


def _compose(cfg, r1, r2):
    """Whole-model roofline terms from the L1 and L2 traces."""
    _, _, units, tail_units = _layer_variants(cfg)
    scale = units - 1 + tail_units

    def comp(f1, f2):
        return f1 + scale * (f2 - f1)

    # clamp: when per-layer collectives vanish (e.g. pure-DP/ZeRO profiles)
    # the L2-L1 delta can be slightly negative (fixed-cost collectives being
    # amortized); extrapolation must not go below zero.
    flops = max(0.0, comp(r1["flops"], r2["flops"]))
    bytes_ = max(0.0, comp(r1["bytes"], r2["bytes"]))
    wire = max(0.0, comp(r1["collectives"]["total"]["wire_bytes"],
                         r2["collectives"]["total"]["wire_bytes"]))
    # counted per device (one rank's program), wire bytes likewise
    terms = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": bytes_ / HBM_BW,
        "collective_s": wire / COLL_BW,
    }
    dom = max(terms, key=terms.get)
    return {
        "l1": r1, "l2": r2, "units": units, "tail_units": tail_units,
        "flops_per_device": flops, "bytes_per_device": bytes_,
        "wire_bytes_per_device": wire, "terms": terms, "dominant": dom,
    }


def _tensor_parallel_report(cfg, shape, model: int = 16):
    """What the step splits over the production mesh's 'model' axis of
    ``model`` ranks: None under a profile that splits no compute; else
    the layout (``tp_layout``), the "model"-tagged leaves computed
    gathered, with why, and for decode where the K/V caches lie: "split
    on the sequence" where 'model' divides it, else "replicated" (the
    hybrid's ``shared_kv`` likewise; the encoder-decoder's ``cross_kv``
    beside it as ``cross_kv_cache``, at S only, since it keeps its
    length); the SSM and hybrid families' where their states and conv
    tails lie (on the heads / channels where 'model' divides them, else
    replicated; the hybrid's tail as ``mamba_tail/...``), with one
    rank's GB of each."""
    if not _profile(cfg, ("data",))[1]:
        return None
    from repro_torch.models import ModelZoo
    defs = ModelZoo(cfg).param_defs()
    decode = shape.kind == "decode"
    out = {"model": model, "layout": tp_layout(cfg, model),
           "gathered_leaves": gathered_leaves(cfg, defs, model)}
    if not decode:
        return out
    # the serving steps' own placement of the caches, on the production
    # mesh's axes and sizes (all that it reads of a mesh)
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"),
                           shape=(256 // model, model))
    caches = ModelZoo(cfg).cache_defs(shape)
    where = {}
    for key in ("mamba", "mamba_tail"):
        for leaf, d in caches.get(key, {}).items():
            place = _cache_placements(cfg, mesh, (key, leaf), d.shape)
            ranks = math.prod(n for n, p in zip(mesh.shape, place)
                              if p.is_shard())
            where[leaf if key == "mamba" else f"{key}/{leaf}"] = dict(
                model=("split on the " + ("heads" if leaf == "state"
                                          else "channels")
                       if place[1].is_shard() else "replicated"),
                gb_per_device=math.prod(d.shape) * 2 / ranks / 1e9)
    if where:
        out["ssm_cache"] = where
    for key in ("kv", "shared_kv", "cross_kv"):
        if key not in caches:
            continue
        kv = caches[key].shape
        split = _seq_split(_cache_placements(cfg, mesh, key, kv), mesh)
        name = "cross_kv_cache" if key == "cross_kv" else "kv_cache"
        out[name] = ("split on the sequence" if split
                     else "replicated: 'model' does not divide "
                     f"the sequence of {shape.seq_len}")
        out[name + "_gb_per_device"] = {"S": _cache_gb(cfg, mesh, kv, key)}
        if key == "cross_kv":
            continue   # widen_mesh_caches leaves it as it is
        # one rank's K/V cache after one widen_mesh_caches (one slot
        # more): "model" divides at most one of S and S + 1, and the
        # other lies whole on every "model" rank
        wide = kv[:3] + (kv[3] + 1,) + kv[4:]
        out[name + "_gb_per_device"]["S+1 (after widen_mesh_caches)"] = \
            _cache_gb(cfg, mesh, wide, key)
    return out


def _cache_gb(cfg, mesh, kv, key: str = "kv") -> float:
    """GB of one rank's shard of a K/V cache (``key``: "kv", the
    hybrid's "shared_kv" or the encoder-decoder's "cross_kv") of shape
    ``kv``, placed as the serving steps place it."""
    ranks = math.prod(n for n, p in zip(mesh.shape, _cache_placements(
        cfg, mesh, key, kv)) if p.is_shard())
    size = {"bfloat16": 2, "float8_e4m3fn": 1}[cfg.kv_cache_dtype]
    return math.prod(kv) * size / ranks / 1e9


def _trace_pass(cfg, shape, multi_pod: bool):
    return _trace(cfg, shape, _mesh(multi_pod))


def _worker_context():
    """The fork server's context, with what it imports once (a torch
    import takes seconds).  This module is not preloaded: a worker of
    the CLI runs it afresh as its main module."""
    import multiprocessing
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["repro_torch.launch",
                                "repro_torch.launch.hloanalysis",
                                "torch.distributed._tools.mem_tracker",
                                "torch.testing._internal.distributed.fake_pg"])
    return ctx


def start_worker_server() -> None:
    """Start the fork server that :func:`run_cell`'s workers come from, so
    that its imports run beside the caller's other work (else the first
    cell with more than one pass starts it).  It is stopped when this
    process exits (:func:`stop_worker_server`)."""
    from multiprocessing import forkserver
    _worker_context()
    forkserver.ensure_running()
    atexit.unregister(stop_worker_server)
    atexit.register(stop_worker_server)


def stop_worker_server() -> None:
    """Stop the fork server and the resource tracker it started, and wait
    for both to end: left alone, each ends only some time after this
    process does (the server first finishes its imports).  Does nothing
    where neither runs."""
    from multiprocessing import forkserver, resource_tracker
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def _run_passes(passes: dict, shape) -> dict:
    """``{name: _trace}`` of every ``name: (cfg, multi_pod)`` pass.  Where
    the host has a core for more than one, the passes run at once in
    worker processes, each rank 0 of its own fake world of this world's
    size.  The workers fork from a single-threaded server (see
    :func:`_worker_context`), not from this process, which may hold
    threads and a CUDA context."""
    workers = min(len(passes), os.cpu_count() or 1)
    if workers == 1:
        return {name: _trace_pass(cfg, shape, multi)
                for name, (cfg, multi) in passes.items()}
    from concurrent.futures import ProcessPoolExecutor
    import torch.distributed as dist
    start_worker_server()
    with ProcessPoolExecutor(
            workers, mp_context=_worker_context(),
            initializer=open_fake_world,
            initargs=(dist.get_world_size(),)) as pool:
        futures = {name: pool.submit(_trace_pass, cfg, shape, multi)
                   for name, (cfg, multi) in passes.items()}
        return {name: f.result() for name, f in futures.items()}


def _print_terms(roof):
    t = roof["terms"]
    print(f"[dryrun]   terms: compute={t['compute_s']:.3e}s "
          f"memory={t['memory_s']:.3e}s coll={t['collective_s']:.3e}s "
          f"dominant={roof['dominant']}", flush=True)


def run_cell(arch: str, shape_name: str, out_dir: str,
             do_multi: bool = True, do_roofline: bool = True,
             variant: str = "baseline", update_roofline: bool = False):
    """Trace one cell and write ``<out_dir>/<arch>__<shape>__<variant>.json``
    in the reference's layout."""
    cfg = dataclasses.replace(get_config(arch), **VARIANTS[variant])
    shape = SHAPES[shape_name]
    os.makedirs(out_dir, exist_ok=True)
    base = f"{arch}__{shape_name}__{variant}"

    if update_roofline:
        # refresh ONLY the roofline pass of an existing artifact (keeps the
        # single/multi-pod traces)
        path = os.path.join(out_dir, base + ".json")
        if not os.path.exists(path):
            print(f"[dryrun] {base}: no artifact to update")
            return {"ok": False}
        with open(path) as f:
            result = json.load(f)
        if result.get("skip_reason"):
            return result
        try:
            print(f"[dryrun] {base}: roofline refresh ...", flush=True)
            cfg1, cfg2, _, _ = _layer_variants(cfg)
            got = _run_passes({"l1": (cfg1, False), "l2": (cfg2, False)},
                              shape)
            result["roofline"] = _compose(cfg, got["l1"], got["l2"])
            _print_terms(result["roofline"])
            result["ok"] = True
            result.pop("error", None)
            result.pop("traceback", None)
        except Exception as e:  # noqa: BLE001
            result["error"] = f"{type(e).__name__}: {e}"
            print(f"[dryrun] {base}: FAIL {result['error']}", flush=True)
        with open(path, "w") as f:
            json.dump(result, f, indent=2)
        return result

    reason = skip_reason(cfg, shape)
    result = {"arch": arch, "shape": shape_name, "variant": variant,
              "skip_reason": reason,
              "model_flops_global": None, "ok": False,
              "device_type": _device_type()}
    if reason is not None:
        result["ok"] = True
        with open(os.path.join(out_dir, base + ".json"), "w") as f:
            json.dump(result, f, indent=2)
        print(f"[dryrun] {base}: SKIP ({reason})")
        return result

    from repro_torch.models import ModelZoo
    result["model_flops_global"] = ModelZoo(cfg).model_flops(shape)
    result["params"] = cfg.param_count()
    result["active_params"] = cfg.active_param_count()
    result["tensor_parallel"] = _tensor_parallel_report(cfg, shape)
    for g in (result["tensor_parallel"] or {}).get("gathered_leaves", []):
        print(f"[dryrun]   gathered over 'model': {g['leaf']} "
              f"({g['reason']})", flush=True)

    passes = {"single_pod": (cfg, False)}
    if do_multi:
        passes["multi_pod"] = (cfg, True)
    if do_roofline:
        cfg1, cfg2, _, _ = _layer_variants(cfg)
        passes.update(l1=(cfg1, False), l2=(cfg2, False))
    try:
        print(f"[dryrun] {base}: single-pod 16x16"
              + (", multi-pod 2x16x16" if do_multi else "")
              + (", roofline L1/L2" if do_roofline else "") + " ...",
              flush=True)
        got = _run_passes(passes, shape)
        sp = result["single_pod"] = got["single_pod"]
        print(f"[dryrun]   single-pod trace {sp['compile_s']}s "
              f"flops/dev={sp['flops']:.3e}", flush=True)
        if sp["exceeds_device_memory"]:
            mem = sp["memory"]
            gb = (mem["argument_size_in_bytes"]
                  + mem["temp_size_in_bytes"]) / 1e9
            print(f"[dryrun]   {gb:.1f} GB per device: over the card's "
                  "80 GB", flush=True)
        if do_multi:
            result["multi_pod"] = got["multi_pod"]
            print(f"[dryrun]   multi-pod trace "
                  f"{result['multi_pod']['compile_s']}s", flush=True)
        if do_roofline:
            result["roofline"] = _compose(cfg, got["l1"], got["l2"])
            _print_terms(result["roofline"])
        result["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, keep driving
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {base}: FAIL {result['error']}", flush=True)

    with open(os.path.join(out_dir, base + ".json"), "w") as f:
        json.dump(result, f, indent=2)
    return result


def open_fake_world(world_size: int = 512) -> None:
    """This process as rank 0 of a fake world (no data moves)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    ap.add_argument("--skip-multi", action="store_true")
    ap.add_argument("--skip-roofline", action="store_true")
    ap.add_argument("--update-roofline", action="store_true",
                    help="recompute only the roofline pass of existing artifacts")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for a in ARCH_NAMES:
            for s in SHAPES:
                reason = skip_reason(get_config(a), SHAPES[s])
                print(f"{a:24s} {s:12s} {'SKIP: ' + reason if reason else 'run'}")
        return

    import torch.distributed as dist
    if not dist.is_initialized():
        open_fake_world(512)
    cells = [(args.arch, args.shape)] if args.arch and args.shape else [
        (a, s) for a in ARCH_NAMES for s in SHAPES]
    ok = True
    for a, s in cells:
        r = run_cell(a, s, args.out, do_multi=not args.skip_multi,
                     do_roofline=not args.skip_roofline, variant=args.variant,
                     update_roofline=args.update_roofline)
        ok = ok and r.get("ok", False) and "error" not in r
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
