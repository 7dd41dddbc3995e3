"""The collectives of the reference's FSDP train step at reduced size, on
the CPU: reduced llama3-8b with ``repro.launch.train.FSDP_PARAM_THRESHOLD``
forced to 0, ``make_train_step`` jitted on a (2 data, 2 model) mesh of
host devices with the placements of ``abstract_train_args``, compiled.
Prints the collectives by kind (``repro.launch.hloanalysis.collective_stats``)
of every computation that holds one (the entry, the layers' scans, the
loss's chunk loop), and every all-gather's result shape with the
parameter stored over "data" that it would be, gathered over "data"
alone (whole, or one layer's slice of a stacked leaf), so that a weight
all-gather shows by name.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python scripts/reference_fsdp_collectives.py
"""
import json
import re

import jax
import numpy as np
from jax.sharding import Mesh

import repro.launch.train as train_mod
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.launch.hloanalysis import collective_stats
from repro.launch.train import abstract_train_args, make_train_step


def computations(hlo: str) -> dict:
    """The HLO module's computations by name, each its text."""
    out, name = {}, None
    for line in hlo.splitlines():
        m = re.match(r"(ENTRY )?%?([\w.\-]+) .*\{$", line)
        if m and not line.startswith(" "):
            name = ("ENTRY " if m.group(1) else "") + m.group(2)
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return {k: "\n".join(v) for k, v in out.items()}


def main():
    train_mod.FSDP_PARAM_THRESHOLD = 0
    cfg = get_config("llama3-8b").reduced()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    args = abstract_train_args(cfg, ShapeSpec("t", "train", 64, 4), mesh,
                               ("data",))
    hlo = jax.jit(make_train_step(cfg)).lower(*args).compile().as_text()
    # each parameter stored over "data", by the shape it has gathered
    # over "data" alone (its "model" shard kept), whole and one layer's
    weights = {}
    for path, p in jax.tree_util.tree_flatten_with_path(args[0])[0]:
        spec = tuple(p.sharding.spec) + (None,) * (len(p.shape) - len(
            p.sharding.spec))
        if "data" not in spec:
            continue
        name = "/".join(k.key for k in path)
        shape = [n // 2 if s == "model" else n for n, s in zip(p.shape, spec)]
        weights[tuple(shape)] = name
        if name.startswith("layers/"):
            weights[tuple(shape[1:])] = name + " (one layer)"
    out = {}
    for name, text in computations(hlo).items():
        stats = collective_stats(text)
        if not stats["total"]["count"]:
            continue
        gathers = re.findall(r"= (\w+\[[\d,]*\])\S* all-gather", text)
        shapes = [tuple(int(d) for d in g.split("[")[1].rstrip("]").split(",")
                        if d) for g in gathers]
        out[name] = dict(
            counts={k: v["count"] for k, v in stats.items() if k != "total"},
            all_gathers=gathers,
            weight_shaped={g: weights[s] for g, s in zip(gathers, shapes)
                           if s in weights})
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
