#!/usr/bin/env python3
"""Hold the fused, tiled, sparse and per-step kernels against another
tree's, bit for bit.

    git archive <commit> src/repro_torch | tar -x -C build/ab_old
    python3 scripts/torch_kernel_ab.py build/ab_old

Runs on a machine with an NVIDIA card.  The inputs of ``chip_smoke.py``'s
main-path launches are made once with this tree and saved under
``build/ab/``: phase 3 (FC8 × 4096 draws, 10,000 periods, β +
watermarks, the fused kernel), phase 4 (torus3d(6) × 256, 2,000 periods,
watermarks, fused), phase 6 (torus3d(22) × 8, 2,000 periods recorded
every 100, watermarks, the tiled kernel), phase 8 (torus3d(100) × 8,
2,000 periods, watermarks, the sparse kernel's grouped pass), phase 8b
(torus3d(22) × 8 on the sparse kernel, direct), a per-draw-table call
(torus3d(8) × 1,024 draws, one dropped link per draw, as in phase 9's
LinkDrop campaign: direct) and phase 10(a) (draw 0 of phase 6 on the
per-step kernel).  Each tree then runs every call in a process of its
own, importing only its own ``src/repro_torch`` and building its kernels
from its own ``csrc/`` into its own ``build/kernels/``, in turns: other,
this, this, other.  Every output (ν records, ψ, ν, β, the four
watermarks, trip records) of this tree's first turn must equal the other
tree's first turn bit for bit.  Prints one JSON line per call with both
trees' CUDA-event times per turn, then the card's ``nvidia-smi`` line.
"""
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "ab"
OUTPUTS = ("freq", "psi", "nu", "beta", "watermarks", "guard_state")


def emit(obj):
    print(json.dumps(obj), flush=True)


def prepare() -> list:
    """Save each call's (kernel, args, kw) under WORK; returns the names."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import fully_connected, make_links, torus3d
    from repro_torch.kernels import EngineOptions, ops, simulate_ensemble_dense
    from repro_torch.kernels.bittide_sparse import ellify
    from repro_torch.telemetry import Telemetry
    dev = torch.device("cuda")
    WORK.mkdir(parents=True, exist_ok=True)
    cpu = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x
    calls = {}

    def dense(name, topo, b, dt, steps, rec, beta, kernel="bittide_fused"):
        links = make_links(topo, cable_m=2.0)
        ppm = np.random.default_rng(0).uniform(-8, 8, (b, topo.num_nodes))
        args, mask = cs.fused_inputs(topo, links, ppm, 2e-8, dev)
        calls[name] = (kernel, args + (float(125e6 * dt),),
                       dict(num_records=steps // rec, record_every=rec,
                            ctrl_mask=mask, record_beta=beta,
                            record_watermarks=True))
    dense("phase3_fc8", fully_connected(8), 4096, 5e-5, 10_000, 20, True)
    dense("phase4_torus3d_6", torus3d(6), 256, 1e-3, 2_000, 20, False)
    dense("phase6_torus3d_22", torus3d(22), 8, 5e-3, 2_000, 100, False,
          kernel="bittide_tiled")

    def sparse(name, k, b):
        topo = torus3d(k)
        ppm = np.random.default_rng(0).uniform(-8, 8, (b, topo.num_nodes))
        with cs.recorded_engine_calls(ops, "_sparse_engine") as rec:
            simulate_ensemble_dense(
                topo, make_links(topo, cable_m=2.0), ppm, 2_000, 2e-8,
                dt=5e-3, record_every=100,
                options=EngineOptions(engine="sparse"),
                telemetry=Telemetry(watermarks=True))
        args, kw = cs.sparse_call_args(rec[0][0])
        calls[name] = ("bittide_sparse", args, kw)
    sparse("phase8_torus3d_100", 100, 8)
    sparse("phase8b_torus3d_22", 22, 8)

    # Per-draw tables: torus3d(8) x 1,024, each draw without one link.
    topo = torus3d(8)
    e = topo.num_edges
    rng = np.random.default_rng(5)
    edge_w = np.ones((1024, e))
    rev = topo.reverse_edge_index()
    for d, pick in enumerate(rng.integers(0, e, 1024)):
        edge_w[d, [pick, rev[pick]]] = 0.0
    nbr, latf, w = ellify(topo, np.full(e, 37.0), edge_w=edge_w)
    put = lambda x: torch.as_tensor(np.array(x, np.float32), device=dev)
    nu_u = put(rng.uniform(-8, 8, (1024, topo.num_nodes)) * 1e-6)
    args = (torch.zeros_like(nu_u), nu_u.clone(), nu_u,
            torch.as_tensor(nbr, device=dev), put(latf), put(w),
            put((w * 37.0).sum(axis=1)), put(np.full(1024, 2e-8)),
            put(np.zeros(1024)), 1000.0)
    calls["per_draw_torus3d_8"] = ("bittide_sparse", args,
                                   dict(num_records=20, record_every=12))

    # Phase 10(a): draw 0 of phase 6 on the per-step kernel, as the
    # per-step lane calls it.
    topo = torus3d(22)
    ppm = np.random.default_rng(0).uniform(-8, 8, (8, topo.num_nodes))[:1]
    with cs.recorded_engine_calls(ops, "_perstep_engine") as rec:
        simulate_ensemble_dense(
            topo, make_links(topo, cable_m=2.0), ppm, 2_000, 2e-8, dt=5e-3,
            record_every=100, options=EngineOptions(engine="per-step"),
            telemetry=Telemetry(watermarks=True))
    args, kw = cs.perstep_call_args(rec[0][0])
    calls["phase10a_torus3d_22"] = ("bittide_step", args, kw)
    del rec

    for name, (kernel, args, kw) in calls.items():
        torch.save(dict(kernel=kernel, args=[cpu(a) for a in args],
                        kw={k: cpu(v) for k, v in kw.items()}),
                   WORK / f"{name}.in.pt")
    return list(calls)


def run(tree: Path, names, tag: str) -> None:
    """In this process: import ``tree``'s port, run and time every call,
    save the outputs of turn ``tag``."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels import bittide_sparse, bittide_step
    kernels = {"bittide_fused": bittide_step.bittide_fused,
               "bittide_tiled": bittide_step.bittide_tiled,
               "bittide_sparse": bittide_sparse.bittide_sparse,
               "bittide_step": bittide_step.bittide_perstep}
    gpu = lambda x: x.cuda() if isinstance(x, torch.Tensor) else x
    times = {}
    for name in names:
        spec = torch.load(WORK / f"{name}.in.pt")
        fn = kernels[spec["kernel"]]
        args = [gpu(a) for a in spec["args"]]
        kw = {k: gpu(v) for k, v in spec["kw"].items()}
        if "lists" in inspect.signature(fn).parameters:
            # A tree whose fused kernel reads row lists: built once here,
            # as the scenario runner builds them once per stack.
            kw["lists"] = bittide_step.row_lists(args[3])
        out = fn(*args, **kw)                    # builds
        warm = time.perf_counter()
        while time.perf_counter() - warm < 1.0:  # the card at its clocks
            fn(*args, **kw)
            torch.cuda.synchronize()
        reps = 5
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args, **kw)
        stop.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(stop) / reps
        saved = {}
        for key in OUTPUTS:
            v = getattr(out, key)
            if isinstance(v, tuple):
                v = [x.cpu() for x in v]
            elif v is not None:
                v = v.cpu()
            saved[key] = v
        torch.save(saved, WORK / f"{name}.{tag}.pt")
        del out, args, kw
        torch.cuda.empty_cache()
    (WORK / f"times.{tag}.json").write_text(json.dumps(times))


def equal(a, b) -> bool:
    import torch
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, list):
        return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    if not (other / "src" / "repro_torch").is_dir():
        print(f"torch_kernel_ab: no src/repro_torch under {other}",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    names = prepare()
    torch.cuda.empty_cache()
    turns = (("other", other, "other1"), ("this", ROOT, "this1"),
             ("this", ROOT, "this2"), ("other", other, "other2"))
    for _, tree, tag in turns:
        subprocess.run([sys.executable, __file__, "--run", str(tree), tag,
                        *names], check=True)
    times = {tag: json.loads((WORK / f"times.{tag}.json").read_text())
             for _, _, tag in turns}
    ok = True
    for name in names:
        a = torch.load(WORK / f"{name}.other1.pt")
        b = torch.load(WORK / f"{name}.this1.pt")
        bits = {key: equal(a[key], b[key]) for key in OUTPUTS}
        ok &= all(bits.values())
        emit(dict(call=name, bits_equal=all(bits.values()), outputs=bits,
                  ms={tag: times[tag][name] for _, _, tag in turns}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit(dict(nvidia_smi=smi, seconds=time.perf_counter() - t0))
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--run":
        run(Path(sys.argv[2]), sys.argv[4:], sys.argv[3])
        sys.exit(0)
    sys.exit(main())
