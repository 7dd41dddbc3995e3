"""The port's launch analysis against the JAX package, on the CPU.

  * ``launch.memmodel.analytic_hbm_bytes`` equals the reference's exactly
    for every arch × shape × ``VARIANTS`` entry × chips in {1, 256, 512},
    and the port's ``VARIANTS`` are the reference's;
  * ``hloanalysis._wire_factor`` equals the reference's for the five kinds
    × n in {1, 2, 3, 4, 16, 32, 512};
  * ``tests/test_hloanalysis.py``'s HLO case rebuilt as torch collectives
    on a fake 8-rank world (on real and on fake tensors): ``OpCounter``'s
    dict equals ``repro.launch.hloanalysis.collective_stats(HLO)`` —
    counts, result bytes, wire bytes, no count of ``wait_tensor`` or
    ``recv``, nothing unmatched; a broadcast is kept in ``unmatched``;
  * ``abstract_train_args`` / ``abstract_serve_args`` against the
    reference's on both production meshes (a 512-device jax subprocess;
    the port's on a fake 512-rank world) for every applicable arch ×
    shape and the ``baseline``, ``puredp``, ``zero3`` and ``kv8``
    variants: each leaf's global shape, its dtype (by name) and its
    placements = ``spec_placements`` of the reference's
    ``NamedSharding.spec``;
  * what the dry run reads of ``MemTracker`` (a private API): the peak
    snapshot per device, ``"Total"`` counting the external tensors;
  * ``roofline.roofline_row`` / ``dryrun_row`` / ``main`` print the
    reference's strings character for character on the same artifacts,
    with ``CHIPS`` / ``HBM_BW`` set to the reference's;
  * the plain train step's FLOPs against the reference's
    ``cost_analysis_dict(jit(step).lower(...).compile())["flops"]`` at
    each family's reduced config (the reference's layers unrolled: XLA
    counts a scan body once).  ``FlopCounterMode`` counts the
    matmul-class operations only; XLA counts the same matmuls and the
    elementwise work as well, so the ratio is below 1, and lowest for the
    SSD families, whose chunked scan is mostly elementwise.  Each ratio
    is pinned within ``RATIO_BAND`` of its value measured on the CPU.
"""
import dataclasses
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.launch import hloanalysis as ref_hlo  # noqa: E402
from repro.launch import memmodel as ref_memmodel  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import dryrun, hloanalysis, memmodel  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from torch_gloo import ROOT, run_fake  # noqa: E402

# tests/test_hloanalysis.py's module, collective for collective
HLO = """
HloModule test
ENTRY %main {
  %p0 = bf16[16,256]{1,0} parameter(0)
  %ar = bf16[16,256]{1,0} all-reduce(%p0), replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=%add
  %ag = bf16[64,256]{1,0} all-gather(%p0), replica_groups=[2,4]<=[8], dimensions={0}
  %rs = bf16[4,256]{1,0} reduce-scatter(%p0), replica_groups={{0,1,2,3}}, to_apply=%add
  %cp = bf16[16,256]{1,0} collective-permute(%p0), source_target_pairs={{0,1}}
  %done = bf16[16,256]{1,0} all-reduce-done(%ar)
}
"""

# port FLOPs / XLA FLOPs of the reduced train step (batch 2 × 64 tokens),
# by family; measured on the CPU with torch 2.13 and jax 0.9
FLOP_RATIOS = {"smollm-135m": 0.8533, "qwen2-moe-a2.7b": 0.8414,
               "mamba2-370m": 0.4222, "zamba2-7b": 0.5225,
               "seamless-m4t-large-v2": 0.8612, "pixtral-12b": 0.8504}
RATIO_BAND = 0.02

ABSTRACT_VARIANTS = ("baseline", "puredp", "zero3", "kv8")

# The reference's abstract arguments, in a jax process of 512 host
# devices (importing repro.launch.dryrun forces them, as it does there).
JAX_ABSTRACT = """
import json, sys
import dataclasses
import jax
import numpy as np
from repro.configs import ARCH_NAMES, get_config
from repro.configs.base import SHAPES, skip_reason
from repro.launch.dryrun import VARIANTS, _mesh
from repro.launch.mesh import dp_axes_of
from repro.launch.train import abstract_serve_args, abstract_train_args


def key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def spec(s):
    return [list(e) if isinstance(e, tuple) else e
            for e in s.sharding.spec]


out = {"variants": {k: dict(v) for k, v in VARIANTS.items()}, "cells": {}}
for mname, multi in (("single_pod", False), ("multi_pod", True)):
    mesh = _mesh(multi)
    dp = dp_axes_of(mesh)
    for arch in ARCH_NAMES:
        for sname, shape in SHAPES.items():
            for variant in VARIANTS_WANTED:
                cfg = dataclasses.replace(get_config(arch), **VARIANTS[variant])
                if skip_reason(cfg, shape) is not None:
                    continue
                build = (abstract_train_args if shape.kind == "train"
                         else abstract_serve_args)
                args = build(cfg, shape, mesh, dp)
                out["cells"][f"{mname}|{arch}|{sname}|{variant}"] = {
                    key(p): [list(s.shape), str(s.dtype), spec(s)]
                    for p, s in jax.tree_util.tree_flatten_with_path(args)[0]}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""

PORT_ABSTRACT = """
import dataclasses, json
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import dp_axes_of
from repro_torch.launch.train import abstract_serve_args, abstract_train_args
from repro_torch.models.layers import spec_placements

REF = json.load(open(REF_PATH))


def flat(tree, prefix):
    if isinstance(tree, (tuple, list)):
        return {k: v for i, t in enumerate(tree)
                for k, v in flat(t, f"{prefix}{i}/").items()}
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def entry(e):
    return tuple(e) if isinstance(e, list) else e


dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
out = {}
for mname, multi in (("single_pod", False), ("multi_pod", True)):
    mesh = dryrun._mesh(multi)
    dp = dp_axes_of(mesh)
    for cell, ref_leaves in REF["cells"].items():
        m, arch, sname, variant = cell.split("|")
        if m != mname:
            continue
        cfg = dataclasses.replace(get_config(arch), **dryrun.VARIANTS[variant])
        shape = SHAPES[sname]
        build = (abstract_train_args if shape.kind == "train"
                 else abstract_serve_args)
        with FakeTensorMode():
            leaves = flat(build(cfg, shape, mesh, dp), "")
        rows = {}
        for k, t in leaves.items():
            assert isinstance(t, DTensor), (cell, k)
            want = ref_leaves.get(k)
            rows[k] = [list(t.shape), str(t.dtype).replace("torch.", ""),
                       str(tuple(t.placements)),
                       None if want is None else str(spec_placements(
                           tuple(entry(e) for e in want[2]), mesh))]
        out[cell] = rows
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_abstract(tmp_path_factory):
    """The reference's VARIANTS and abstract arguments (one subprocess)."""
    path = tmp_path_factory.mktemp("abstract") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    code = f"VARIANTS_WANTED = {ABSTRACT_VARIANTS!r}\n" + JAX_ABSTRACT
    proc = subprocess.run([sys.executable, "-c", code, str(path)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return path, json.loads(path.read_text())


def test_variants_are_the_reference_variants(reference_abstract):
    _, ref = reference_abstract
    assert dryrun.VARIANTS == ref["variants"]


def _outcome(fn, *args):
    """A call's value, or the type of what it raised."""
    try:
        return ("value", fn(*args))
    except Exception as e:  # noqa: BLE001 — compared with the reference's
        return ("raises", type(e).__name__)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_analytic_hbm_bytes_equal_the_reference(arch):
    """Every shape × ``VARIANTS`` entry × chip count, exactly.  Under the
    ``tp`` profile one chip leaves no data-parallel chip (``chips //
    16``): the reference divides by zero there, and so does the copy."""
    outcomes = []
    for sname in SHAPES:
        for variant, delta in dryrun.VARIANTS.items():
            cfg = dataclasses.replace(get_config(arch), **delta)
            ref_cfg = dataclasses.replace(ref_get_config(arch), **delta)
            for chips in (1, 256, 512):
                got = _outcome(memmodel.analytic_hbm_bytes, cfg,
                               SHAPES[sname], chips)
                want = _outcome(ref_memmodel.analytic_hbm_bytes, ref_cfg,
                                REF_SHAPES[sname], chips)
                assert got == want, (sname, variant, chips, got, want)
                outcomes.append((chips, got[0]))
    assert len(outcomes) == len(SHAPES) * len(dryrun.VARIANTS) * 3
    assert all(kind == "value" for chips, kind in outcomes if chips > 1)
    assert {kind for chips, kind in outcomes if chips == 1} == {
        "value", "raises"}


@pytest.mark.parametrize("kind", hloanalysis.COLLECTIVE_KINDS)
def test_wire_factor_equals_the_reference(kind):
    for n in (1, 2, 3, 4, 16, 32, 512):
        assert hloanalysis._wire_factor(kind, n) == \
            ref_hlo._wire_factor(kind, n), (kind, n)


def test_dtype_bytes_cover_the_reference_and_torch():
    for name, size in ref_hlo.DTYPE_BYTES.items():
        assert hloanalysis.DTYPE_BYTES[name] == size
    for dt in (torch.bool, torch.int8, torch.int32, torch.int64,
               torch.bfloat16, torch.float16, torch.float32,
               torch.float8_e4m3fn, torch.complex64):
        assert hloanalysis.DTYPE_BYTES[dt] == \
            torch.empty(0, dtype=dt).element_size(), dt


@pytest.mark.parametrize("name", ["float8_e5m2fnuz", "float8_e4m3fnuz",
                                  "float8_e8m0fnu"])
def test_bytes_accessed_count_dtypes_outside_the_table(name):
    """A dtype that ``DTYPE_BYTES`` does not list is counted by its
    element size, not refused."""
    dt = getattr(torch, name)
    assert dt not in hloanalysis.DTYPE_BYTES
    x = torch.zeros(4, 3, dtype=dt)
    with hloanalysis.OpCounter() as counter:
        x.clone()
    assert counter.bytes_accessed == 2 * 12 * x.element_size() > 0


HLO_AS_TORCH = """
import json
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.hloanalysis import OpCounter

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
groups = [dist.new_group([0, 1, 2, 3]), dist.new_group([4, 5, 6, 7])]
g4 = groups[0]


def hlo_module():
    p0 = torch.zeros(16, 256, dtype=torch.bfloat16)
    # %ar: all-reduce over groups of 4 (c10d, in place)
    dist.all_reduce(p0, group=g4)
    # %ag: all-gather to 64 x 256 over groups of 4 (functional + its wait)
    ag = funcol.all_gather_tensor(p0, 0, g4)
    ag = funcol.wait_tensor(ag) if hasattr(funcol, "wait_tensor") else ag
    assert tuple(ag.shape) == (64, 256)
    # %rs: reduce-scatter to 4 x 256 over a group of 4
    rs = torch.empty(4, 256, dtype=torch.bfloat16)
    dist.reduce_scatter_tensor(rs, p0, group=g4)
    # %cp: one point-to-point hop, and its receive (not counted)
    dist.send(p0, dst=1)
    dist.recv(torch.empty_like(p0), src=1)
    # %done: the all-reduce's completion (not counted)
    torch.ops._c10d_functional.wait_tensor(p0)


out = {}
for name, fake in (("real", False), ("fake", True)):
    counter = OpCounter()
    if fake:
        with FakeTensorMode(), counter:
            hlo_module()
    else:
        with counter:
            hlo_module()
    out[name] = dict(stats=counter.collective_stats(),
                     unmatched=counter.unmatched)
counter = OpCounter()
with counter:
    dist.broadcast(torch.zeros(4), src=0, group=g4)
out["broadcast"] = dict(stats=counter.collective_stats(),
                        unmatched=counter.unmatched)
print(json.dumps(out))
"""


def test_counter_reproduces_the_hlo_collective_stats():
    """tests/test_hloanalysis.py's module as torch collectives on a fake
    8-rank world: the reference's dict, key for key."""
    proc = run_fake(HLO_AS_TORCH)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    want = ref_hlo.collective_stats(HLO)
    for name in ("real", "fake"):
        assert out[name]["unmatched"] == [], name
        assert out[name]["stats"] == json.loads(json.dumps(want)), name
    assert want["all-reduce"]["count"] == 1           # -done not counted
    assert want["total"]["count"] == 4
    assert out["broadcast"]["unmatched"] == ["c10d.broadcast_"]
    assert out["broadcast"]["stats"]["total"]["count"] == 0


def test_cost_analysis_dict_counts_matmul_flops_and_bytes():
    """FLOPs by ``FlopCounterMode`` (2·m·n·k); bytes accessed: every
    operation's inputs and outputs, views excluded."""
    a = torch.ones(8, 16)
    b = torch.ones(16, 4)
    got = hloanalysis.cost_analysis_dict(lambda x, y: (x @ y).t().relu(),
                                         a, b)
    # mm reads 128 + 64 floats, writes 32; .t() is a view; relu 32 in/out
    assert got == {"flops": 2.0 * 8 * 16 * 4,
                   "bytes accessed": 4.0 * (128 + 64 + 32 + 32 + 32)}


def test_memtracker_peak_is_what_the_dry_run_reads():
    """``MemTracker`` (``torch.distributed._tools``, private): under
    ``FakeTensorMode`` its peak snapshot is keyed by device, and
    ``"Total"`` counts the tracked external tensors and every live
    result.  The dry run's temp bytes are that peak less the
    arguments'."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    with FakeTensorMode():
        x = torch.empty(1024, dtype=torch.float32)
        tracker = MemTracker()
        tracker.track_external(x)
        with tracker:
            y = x * 2.0          # 4 KiB live
            z = y + 1.0          # 8 KiB live at once
            del y
            w = z.sum()
        del w
    peak = tracker.get_tracker_snapshot("peak")
    assert list(peak) == [torch.device("cpu")]
    assert peak[torch.device("cpu")]["Total"] == 3 * 4096


def test_abstract_args_equal_the_reference_on_production_meshes(
        reference_abstract):
    path, ref = reference_abstract
    proc = run_fake(f"REF_PATH = {str(path)!r}\n" + PORT_ABSTRACT,
                    timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    port = json.loads(proc.stdout)
    assert sorted(port) == sorted(ref["cells"])
    kinds = {REF_SHAPES[c.split("|")[2]].kind for c in port}
    assert kinds == {"train", "prefill", "decode"}
    assert {c.split("|")[3] for c in port} == set(ABSTRACT_VARIANTS)
    for cell, leaves in port.items():
        want = ref["cells"][cell]
        assert sorted(leaves) == sorted(want), cell
        for k, (shape, dtype, placements, expected) in leaves.items():
            assert shape == want[k][0], (cell, k)
            assert dtype == want[k][1], (cell, k, dtype, want[k][1])
            assert placements == expected, (cell, k, want[k][2])
    # the f8 cache and both production meshes were reached
    f8 = [c for c, leaves in port.items() if any(
        v[1] == "float8_e4m3fn" for v in leaves.values())]
    assert f8 and all(c.endswith("|kv8") for c in f8)
    assert {c.split("|")[0] for c in port} == {"single_pod", "multi_pod"}


# ------------------------------------------------------------ roofline

def _artifacts():
    """A skipped cell, a traced-only cell, full rows and a variant."""
    coll = {k: {"count": 0, "result_bytes": 0, "wire_bytes": 0.0}
            for k in ref_hlo._COLL}
    coll["all-reduce"] = {"count": 26, "result_bytes": 1 << 20,
                          "wire_bytes": 1.5 * (1 << 20)}
    coll["total"] = {"count": 26, "result_bytes": 1 << 20,
                     "wire_bytes": 1.5 * (1 << 20)}
    sp = {"compile_s": 12.34, "flops": 3.0e14, "bytes": 2.0e13,
          "memory": {"argument_size_in_bytes": 7 << 30,
                     "output_size_in_bytes": 7 << 30,
                     "temp_size_in_bytes": 3 << 29,
                     "alias_size_in_bytes": 0,
                     "generated_code_size_in_bytes": 0},
          "collectives": coll}

    def full(arch, shape, variant, scale):
        terms = {"compute_s": 0.25 * scale, "memory_s": 3.5 * scale,
                 "collective_s": 0.01}
        return {"arch": arch, "shape": shape, "variant": variant,
                "skip_reason": None, "model_flops_global": 1.6e15,
                "ok": True, "single_pod": sp, "multi_pod": dict(sp,
                                                                compile_s=9.8),
                "roofline": {"flops_per_device": 1.4e14 * scale,
                             "terms": terms,
                             "dominant": max(terms, key=terms.get)}}
    return [
        {"arch": "llama3-8b", "shape": "long_500k", "variant": "baseline",
         "skip_reason": "pure full-attention architecture: 512k-token "
                        "decode requires sub-quadratic attention (spec: "
                        "skip and note in DESIGN.md)",
         "model_flops_global": None, "ok": True},
        {"arch": "internlm2-1.8b", "shape": "prefill_32k",
         "variant": "baseline", "skip_reason": None,
         "model_flops_global": 1.2e15, "ok": True, "single_pod": sp},
        full("smollm-135m", "train_4k", "baseline", 1.0),
        full("smollm-135m", "train_4k", "zero3", 0.8),
        full("mamba2-370m", "decode_32k", "kv8", 1.2),
        full("mamba2-370m", "decode_32k", "baseline", 1.0),
    ]


@pytest.fixture
def reference_constants(monkeypatch):
    """The port's roofline priced as the reference's (its CHIPS and
    HBM_BW), and the reference's ``_variant_cfg`` on the VARIANTS that
    ``test_variants_are_the_reference_variants`` holds equal (importing
    ``repro.launch.dryrun`` here would force 512 jax devices on this
    process)."""
    monkeypatch.setattr(roofline, "CHIPS", ref_roofline.CHIPS)
    monkeypatch.setattr(roofline, "HBM_BW", ref_roofline.HBM_BW)
    monkeypatch.setattr(ref_roofline, "_variant_cfg", lambda a, v: (
        dataclasses.replace(ref_get_config(a), **dryrun.VARIANTS.get(v, {}))))


def test_rows_equal_the_reference_character_for_character(
        reference_constants):
    assert roofline.HBM_BW == 819e9
    for d in _artifacts():
        assert roofline.dryrun_row(d) == ref_roofline.dryrun_row(d)
        assert roofline.roofline_row(d) == ref_roofline.roofline_row(d)


def test_the_card_prices_the_rows():
    """Unpatched, the rows take the card's HBM rate from the dry run."""
    assert roofline.HBM_BW is dryrun.HBM_BW and roofline.CHIPS == 256
    row = roofline.roofline_row(_artifacts()[2])
    cfg = get_config("smollm-135m")
    fused = memmodel.analytic_hbm_bytes(cfg, SHAPES["train_4k"], 256) \
        / 3.35e12
    assert f"| {fused:.3e} |" in row


def test_main_prints_the_three_tables(tmp_path, reference_constants,
                                      monkeypatch):
    for d in _artifacts():
        (tmp_path / f"{d['arch']}__{d['shape']}__{d['variant']}.json") \
            .write_text(json.dumps(d))
    port, ref = io.StringIO(), io.StringIO()
    with redirect_stdout(port):
        roofline.main(["--dir", str(tmp_path)])
    monkeypatch.setattr(sys, "argv", ["roofline", "--dir", str(tmp_path)])
    with redirect_stdout(ref):
        ref_roofline.main()
    text = port.getvalue()
    assert text == ref.getvalue()
    for title in ("### §Dry-run", "### §Roofline", "### §Perf variants"):
        assert title in text
    assert "smollm-135m × train_4k × zero3" in text
    assert "mamba2-370m × decode_32k × kv8" in text


@pytest.mark.parametrize("arch", sorted(FLOP_RATIOS))
def test_plain_step_flops_against_the_reference(arch):
    import jax
    import jax.numpy as jnp
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro.configs import get_config as ref_get_config
    from repro.configs.base import ShapeSpec as RefShapeSpec
    from repro.launch.hloanalysis import cost_analysis_dict
    from repro.launch.train import make_train_step as ref_train_step
    from repro.models import ModelZoo as RefZoo
    from repro.models.layers import abstract as ref_abstract
    from repro.models.layers import dtype_of as ref_dtype_of
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import hloanalysis
    from repro_torch.launch.train import abstract_train_args, make_train_step

    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                  unroll_layers=True)
    zoo = RefZoo(ref_cfg)
    params = ref_abstract(zoo.param_defs(), ref_dtype_of(ref_cfg.param_dtype))
    mdt = ref_dtype_of(ref_cfg.opt_moment_dtype)
    mom = lambda: jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, mdt),
                               params)
    count = jax.ShapeDtypeStruct((), jnp.int32)
    batch = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in
             zoo.input_defs(RefShapeSpec("t", "train", 64, 2)).items()}
    compiled = jax.jit(ref_train_step(ref_cfg)).lower(
        params, {"mu": mom(), "nu": mom(), "count": count}, batch,
        count).compile()
    want = cost_analysis_dict(compiled)["flops"]

    cfg = get_config(arch).reduced()
    with FakeTensorMode():
        args = abstract_train_args(cfg, ShapeSpec("t", "train", 64, 2), None,
                                   ("data",), device="cpu")
        got = hloanalysis.cost_analysis_dict(make_train_step(cfg), *args)
    ratio = got["flops"] / want
    assert ratio < 1.0, (arch, got["flops"], want)
    assert abs(ratio - FLOP_RATIOS[arch]) <= RATIO_BAND, (arch, ratio)
