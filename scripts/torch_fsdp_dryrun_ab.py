"""The dry run's GB per device for the FSDP architectures, two trees of
the port side by side, and the bytes the FSDP layer gather should save.

    PYTHONPATH=src python scripts/torch_fsdp_dryrun_ab.py --predict
    PYTHONPATH=src python scripts/torch_fsdp_dryrun_ab.py --parent build/parent \\
        [--out build/fsdp_dryrun_ab.json] [--jobs 8]

``--predict`` needs no trace: for each cell it prints, from
``param_defs`` and ``leaf_roles`` on the (16, 16) mesh
(``models.fsdp.held_view_bytes``), the bytes per
device of the stacked FSDP leaves' compute views (each rank's "model"
shard of a split leaf, the whole of a gathered one, the column ranges of
a sliced one), all layers (V) and one layer (or hybrid group) (v), in
the parameters' dtype.  A step that holds every view at once and a train
step that also holds their whole gradients fall, once the views are
gathered layer by layer, by about V - 2v (serving) and 2 (V - 2v)
(train).

``--timeline ARCH SHAPE`` traces one train cell in this process on a
fake 512-rank world, both ways (layer-gathered, and whole as the parent
gathered), and prints where each peaks (``timeline``).

With ``--parent``, it runs ``python -m repro_torch.launch.dryrun`` (the
single-pod pass only: ``--skip-multi --skip-roofline``) for every cell
on this tree and on the tree at ``--parent`` (a checkout of another
commit's ``src``), as many at once as ``--jobs``, and prints one JSON
row per cell: GB per device (arguments + temporaries), FLOPs per device
and collective counts of both, with the prediction beside them.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CELLS = (("arctic-480b", "train_4k"), ("arctic-480b", "prefill_32k"),
         ("arctic-480b", "decode_32k"), ("phi3-medium-14b", "train_4k"),
         ("llama3-8b", "train_4k"), ("pixtral-12b", "train_4k"),
         ("qwen2-moe-a2.7b", "decode_32k"), ("zamba2-7b", "decode_32k"),
         ("seamless-m4t-large-v2", "decode_32k"))


def predict(arch: str, shape: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models.fsdp import held_view_bytes
    b = held_view_bytes(get_config(arch), 16)
    v_gb, unit_gb = b["bytes"] / 1e9, b["unit_bytes"] / 1e9
    fall = v_gb - 2 * unit_gb
    return dict(V_gb=v_gb, v_gb=unit_gb,
                fall_gb=2 * fall if shape.startswith("train") else fall)


def run_cell(src: Path, arch: str, shape: str) -> dict:
    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ, PYTHONPATH=str(src))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--skip-multi", "--skip-roofline",
             "--out", out], capture_output=True, text=True, env=env,
            cwd=out)
        path = Path(out) / f"{arch}__{shape}__baseline.json"
        if proc.returncode or not path.exists():
            return {"error": proc.stderr[-2000:]}
        r = json.loads(path.read_text())
    sp = r["single_pod"]
    mem = sp["memory"]
    return dict(gb_per_device=(mem["argument_size_in_bytes"]
                               + mem["temp_size_in_bytes"]) / 1e9,
                argument_gb=mem["argument_size_in_bytes"] / 1e9,
                temp_gb=mem["temp_size_in_bytes"] / 1e9,
                flops=sp["flops"], trace_s=sp["compile_s"],
                collectives={k: v["count"]
                             for k, v in sp["collectives"].items()},
                unmatched=sp["unmatched_collectives"])


def timeline(arch: str, shape: str, window: int = 4000) -> dict:
    """Where one rank's train step of ``arch`` on the (16, 16) mesh of a
    fake world peaks, with the stacked FSDP leaves gathered layer by
    layer ("layer") and gathered whole before the first layer
    ("whole", the parent's path: ``_layer_gather`` made to hold no
    leaf): the peak of live device memory less the arguments (GB), the
    matmuls dispatched before it over all the step's, and the
    reduce-scatters before it; the curve of live memory over the step,
    sampled at every twentieth matmul; and the rise into the peak: from
    the lowest point of the ``window`` operations before it, the
    largest tensors made on the way (operation, GB, shape, dtype, the
    port's innermost source line for each of at least 1 GB, and how
    many times each was made)."""
    import traceback
    import torch
    import torch.distributed as dist
    from torch.utils._pytree import tree_leaves
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    import repro_torch.launch.train as train_mod
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun

    class Timeline(MemTracker):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented:
                made = [t for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor)]
                big = max(made, default=None,
                          key=lambda t: t.numel() * t.element_size())
                n = 0 if big is None else big.numel() * big.element_size()
                where = None
                if n >= 1e9:
                    where = next((
                        f"{f.filename.split('src/')[-1]}:{f.lineno} {f.name}"
                        for f in reversed(traceback.extract_stack())
                        if "repro_torch" in f.filename), None)
                self.ops.append((func._opname, sum(
                    v["Total"] for v in self._curr_mem_snap.values()), n,
                    None if big is None else list(big.shape),
                    None if big is None else str(big.dtype), where))
            return out

    if not dist.is_initialized():
        dryrun.open_fake_world(512)
    cfg, mesh = get_config(arch), dryrun._mesh(False)
    layer_gather = train_mod._layer_gather
    out = {}
    for name in ("whole", "layer"):
        if name == "whole":
            train_mod._layer_gather = lambda c, m, p, r, a: None
        try:
            step, build = dryrun._step_and_args(cfg, SHAPES[shape], mesh)
            with FakeTensorMode():
                args = build()
                local = dryrun._local_leaves(args)
                tracker = Timeline()
                tracker.track_external(*local)
                with tracker:
                    step(*args)
        finally:
            train_mod._layer_gather = layer_gather
        ops = tracker.ops
        at = max(range(len(ops)), key=lambda i: ops[i][1])
        mm = [i for i, op in enumerate(ops) if op[0] in ("mm", "bmm")]
        base = dryrun._nbytes(local)
        lo = min(range(max(0, at - window), at + 1), key=lambda i: ops[i][1])
        made = {}
        for op, _, n, sh, dt, w in ops[lo:at + 1]:
            k = (op, n, str(sh), dt, w)
            made[k] = dict(op=op, gb=n / 1e9, shape=sh, dtype=dt, where=w,
                           times=made.get(k, {}).get("times", 0) + 1)
        largest = sorted(made.values(), key=lambda m: -m["gb"])[:12]
        out[name] = dict(
            temp_gb=(ops[at][1] - base) / 1e9,
            matmuls_before_peak=sum(i < at for i in mm), matmuls=len(mm),
            reduce_scatters_before_peak=sum(
                "reduce_scatter" in op[0] for op in ops[:at]),
            # live memory less the arguments after every twentieth matmul
            curve_gb=[round((ops[i][1] - base) / 1e9, 2)
                      for i in mm[::max(1, len(mm) // 20)]],
            rise=dict(from_gb=(ops[lo][1] - base) / 1e9, ops=at - lo,
                      largest=largest))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--predict", action="store_true")
    ap.add_argument("--timeline", nargs=2, metavar=("ARCH", "SHAPE"))
    ap.add_argument("--parent")
    ap.add_argument("--out")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    args = ap.parse_args(argv)
    if args.timeline:
        print(json.dumps(dict(arch=args.timeline[0], shape=args.timeline[1],
                              **timeline(*args.timeline))))
        return 0
    rows = [dict(arch=a, shape=s, prediction=predict(a, s)) for a, s in CELLS]
    if args.predict or not args.parent:
        for r in rows:
            print(json.dumps(r))
        return 0
    trees = {"parent": Path(args.parent).resolve() / "src",
             "tree": ROOT / "src"}
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        futures = {(i, name): pool.submit(run_cell, src, r["arch"],
                                          r["shape"])
                   for i, r in enumerate(rows) for name, src in trees.items()}
        for (i, name), f in futures.items():
            rows[i][name] = f.result()
    ok = True
    for r in rows:
        p, t = r["parent"], r["tree"]
        if "error" in p or "error" in t:
            ok = False
        else:
            r["fall_gb"] = p["gb_per_device"] - t["gb_per_device"]
            r["flops_equal"] = p["flops"] == t["flops"]
        print(json.dumps(r), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
