#!/usr/bin/env python3
"""Time the ring geometries of the port's tiled and per-step kernels on
one NVIDIA card.

    python3 scripts/torch_ring_sweep.py [--k 22] [--draws 8]

Builds ``csrc/bittide_tiled.cu`` and ``csrc/bittide_step.cu`` once per
geometry — the ring's depth ``kStages``, its panel height ``kTileJ`` and
its rows per CTA ``kTileI`` —
from copies of ``src/repro_torch/kernels/csrc/`` under
``build/ring_sweep/``, runs each at torus3d(k) (B draws on the tiled
kernel, draw 0 on the per-step kernel; one record of 100 periods, no
measure pass) in turns (every geometry, then every geometry in reverse),
holds every geometry's bits to the committed geometry's, and prints one
JSON line per geometry: ms per pass in both turns, the achieved TB/s of
the stack stream, dynamic shared memory and CTAs per SM.  Needs the CUDA
toolkit's ``nvcc`` and one card; exits 2 without a card.
"""
import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (kStages, kTileJ, kTileI) per kernel; the first of each is the
# committed one.
GEOMETRIES = {
    "bittide_tiled": ((4, 64, 32), (6, 64, 32), (8, 64, 32), (4, 32, 32),
                      (6, 32, 32), (4, 128, 32), (4, 64, 64), (4, 32, 64),
                      (2, 64, 64), (3, 32, 64)),
    "bittide_step": ((4, 32, 32), (6, 32, 32), (8, 32, 32), (4, 64, 32),
                     (6, 64, 32), (8, 64, 32), (4, 16, 32), (4, 32, 64),
                     (2, 32, 64), (4, 16, 64)),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def build_variants(out_dir: Path) -> dict:
    """(kernel, stages, tile_j) -> loaded library, all built in parallel."""
    from repro_torch.kernels import build
    from repro_torch.kernels.bittide_step import _declare
    procs = []
    for kernel, geoms in GEOMETRIES.items():
        for stages, tj, ti in geoms:
            d = out_dir / f"{kernel}_s{stages}_j{tj}_i{ti}"
            d.mkdir(parents=True, exist_ok=True)
            for f in build.CSRC.glob("*.cuh"):
                shutil.copy(f, d / f.name)
            src = (build.CSRC / f"{kernel}.cu").read_text()
            src = re.sub(r"constexpr int kStages = \d+;",
                         f"constexpr int kStages = {stages};", src)
            src = re.sub(r"constexpr int kTileJ = \d+;",
                         f"constexpr int kTileJ = {tj};", src)
            src = re.sub(r"constexpr int kTileI = \d+;",
                         f"constexpr int kTileI = {ti};", src)
            (d / f"{kernel}.cu").write_text(src)
            lib = d / f"lib{kernel}.so"
            procs.append(((kernel, stages, tj, ti), lib, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                 str(d / f"{kernel}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for key, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        libs[key] = _declare(key[0], ctypes.CDLL(str(lib)))
    return libs


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_ring_sweep: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=22)
    ap.add_argument("--draws", type=int, default=8)
    opts = ap.parse_args()
    import chip_smoke as cs
    from repro_torch.core import make_links, torus3d
    from repro_torch.kernels import bittide_step as bs

    libs = build_variants(ROOT / "build" / "ring_sweep")
    dev = torch.device("cuda")
    topo = torus3d(opts.k)
    n = topo.num_nodes
    ppm = np.random.default_rng(0).uniform(-8, 8, (opts.draws, n))
    args, mask = cs.fused_inputs(topo, make_links(topo, cable_m=2.0), ppm,
                                 2e-8, dev)
    dt_frames = 625000.0
    row = lambda x: x[0].contiguous()
    pargs = (row(args[0]), row(args[1]), row(args[2]), args[3], args[4],
             row(args[5]), row(args[6]), float(args[7][0]),
             float(args[8][0]), dt_frames)
    kw = dict(num_records=1, record_every=100)
    calls = {"bittide_tiled": lambda: bs.bittide_tiled(
                 *args, dt_frames, ctrl_mask=mask, **kw),
             "bittide_step": lambda: bs.bittide_perstep(
                 *pargs, ctrl_mask=mask[0].contiguous(), **kw)}
    library, tile_j, step_tile_j = bs._library, bs.TILE_J, bs.PERSTEP_TILE_J

    def use(kernel, g):
        """Route ``kernel``'s wrapper to geometry g = (stages, tile_j,
        tile_i)."""
        bs._library = lambda name: libs[(kernel, *g)]
        bs.TILE_J = g[1] if kernel == "bittide_tiled" else tile_j
        bs.PERSTEP_TILE_J = g[1] if kernel == "bittide_step" else step_tile_j

    emit(dict(nvidia_smi=cs.nvidia_smi_line(), topology=topo.name, nodes=n,
              draws=opts.draws, stack_bytes=4 * args[3].numel()))
    try:
        for kernel, geoms in GEOMETRIES.items():
            use(kernel, geoms[0])
            ref = calls[kernel]()
            ms = {g: [] for g in geoms}
            for g in list(geoms) + list(geoms)[::-1]:
                use(kernel, g)
                got = calls[kernel]()
                assert torch.equal(got.freq, ref.freq) and \
                    torch.equal(got.psi, ref.psi), (kernel, g)
                ms[g].append(cs.cuda_ms(calls[kernel], 2) / 100)
            for g in geoms:
                use(kernel, g)
                plan = bs.device_plan(kernel, min(opts.draws, 8))
                assert (plan["stages"], plan["tile_j"], plan["tile_i"]) == g, \
                    (plan, g)
                emit(dict(kernel=kernel, stages=g[0], tile_j=g[1],
                          tile_i=g[2],
                          committed=g == geoms[0], ms_per_pass=ms[g],
                          tb_per_s=4 * args[3].numel() / min(ms[g]) / 1e9,
                          bits_equal_committed=True,
                          smem_bytes=plan["smem_bytes"],
                          ctas_per_sm=plan["ctas_per_sm"]))
    finally:
        bs._library, bs.TILE_J, bs.PERSTEP_TILE_J = (library, tile_j,
                                                     step_tile_j)
    return 0


if __name__ == "__main__":
    sys.exit(main())
