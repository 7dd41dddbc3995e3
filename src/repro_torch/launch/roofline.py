"""The §Dry-run, §Roofline and §Perf-variants tables of the port's dry
run (port of ``repro.launch.roofline``), from its artifacts.

    PYTHONPATH=src python -m repro_torch.launch.roofline \
        [--dir artifacts/dryrun_torch] [--variant baseline]

``CHIPS`` is the single-pod roofline basis (256 cards); ``HBM_BW`` is
the card's (``launch.dryrun.HBM_BW``: NVIDIA H100 80GB HBM3, data
sheet), which also prices memmodel's fused estimate.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
from typing import Dict

from repro_torch.launch.dryrun import HBM_BW

CHIPS = 256  # single-pod roofline basis


def _variant_cfg(arch: str, variant: str):
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import VARIANTS
    return dataclasses.replace(get_config(arch), **VARIANTS.get(variant, {}))


def load(out_dir: str) -> Dict[str, dict]:
    rows = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            d = json.load(f)
        rows[f"{d['arch']}__{d['shape']}__{d.get('variant', 'baseline')}"] = d
    return rows


def fmt_bytes(n):
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}TiB"


def roofline_row(d: dict) -> str:
    name = f"{d['arch']} × {d['shape']}"
    if d.get("skip_reason"):
        return f"| {name} | — | — | — | — | — | SKIP | — | — | {d['skip_reason'][:50]} |"
    if "roofline" not in d:
        return f"| {name} | compiled | | | | | | | | |"
    r = d["roofline"]
    t = r["terms"]
    dom = r["dominant"].replace("_s", "")
    mf = d.get("model_flops_global") or 0.0
    useful = mf / (r["flops_per_device"] * CHIPS) if r["flops_per_device"] else 0
    bound = max(t.values())
    frac = t["compute_s"] / bound if bound else 0.0
    # fusion-aware deployable estimate (memmodel.py): the per-op bytes have
    # no fusion; a card's HBM traffic is closer to the analytic stream model.
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.memmodel import analytic_hbm_bytes
    try:
        cfg = _variant_cfg(d["arch"], d.get("variant", "baseline"))
        mem_fused = analytic_hbm_bytes(cfg, SHAPES[d["shape"]], CHIPS) / HBM_BW
    except Exception:
        mem_fused = float("nan")
    dep_bound = max(t["compute_s"], t["collective_s"], mem_fused)
    dep_frac = t["compute_s"] / dep_bound if dep_bound else 0.0
    fixes = {
        "compute": "reduce padded/recompute FLOPs (remat policy, causal skip)",
        "memory": "fuse/remat less; bigger per-op tiles; fewer re-reads",
        "collective": "reduce-scatter grads, cache weight gathers, overlap",
    }
    return (f"| {name} | {t['compute_s']:.3e} | {t['memory_s']:.3e} | "
            f"{mem_fused:.3e} | {t['collective_s']:.3e} | **{dom}** | "
            f"{useful:.2f} | {frac:.3f} | {dep_frac:.3f} | {fixes[dom]} |")


def dryrun_row(d: dict) -> str:
    name = f"{d['arch']} × {d['shape']}"
    if d.get("skip_reason"):
        return f"| {name} | SKIP | SKIP | — | — | {d['skip_reason'][:46]}… |"
    sp, mp = d.get("single_pod", {}), d.get("multi_pod", {})
    mem = sp.get("memory", {})
    per_dev = (mem.get("argument_size_in_bytes", 0) +
               mem.get("temp_size_in_bytes", 0))
    coll = sp.get("collectives", {}).get("total", {})
    return (f"| {name} | ✓ ({sp.get('compile_s', '?')}s) | "
            f"{'✓ (' + str(mp.get('compile_s', '?')) + 's)' if mp else '—'} | "
            f"{fmt_bytes(per_dev)} | {coll.get('count', 0)} | "
            f"{fmt_bytes(coll.get('wire_bytes', 0))} wire |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    ap.add_argument("--variant", default="baseline")
    args = ap.parse_args(argv)
    rows = load(args.dir)

    print("### §Dry-run (16×16 single-pod and 2×16×16 multi-pod)\n")
    print("| arch × shape | single-pod | multi-pod | bytes/device (args+temps) "
          "| collectives | wire bytes/device |")
    print("|---|---|---|---|---|---|")
    for k in sorted(rows):
        if k.endswith(f"__{args.variant}"):
            print(dryrun_row(rows[k]))

    print("\n### §Roofline (single-pod, per-chip seconds per step)\n")
    print("| arch × shape | compute_s | memory_s (per-op) | memory_s (fused est.) "
          "| collective_s | dominant | useful (6ND/HLO) | roofline frac "
          "| deployable frac | what would move the bottleneck |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for k in sorted(rows):
        if k.endswith(f"__{args.variant}"):
            print(roofline_row(rows[k]))

    variants = sorted({k.rsplit("__", 1)[1] for k in rows} - {args.variant})
    if variants:
        print("\n### §Perf variants\n")
        print("| arch × shape × variant | compute_s | memory_s | collective_s "
              "| dominant | Δ dominant vs baseline |")
        print("|---|---|---|---|---|---|")
        for k in sorted(rows):
            d = rows[k]
            v = d.get("variant", "baseline")
            if v == args.variant or "roofline" not in d:
                continue
            base = rows.get(f"{d['arch']}__{d['shape']}__baseline", {})
            t = d["roofline"]["terms"]
            dom_b = base.get("roofline", {}).get("dominant")
            delta = ""
            if dom_b:
                b = base["roofline"]["terms"][dom_b]
                n = t[dom_b]
                delta = f"{(n - b) / b * 100:+.1f}% on {dom_b.replace('_s','')}"
            print(f"| {d['arch']} × {d['shape']} × {v} | {t['compute_s']:.3e} "
                  f"| {t['memory_s']:.3e} | {t['collective_s']:.3e} "
                  f"| {d['roofline']['dominant'].replace('_s','')} | {delta} |")


if __name__ == "__main__":
    main()
