"""The port's meshes, sharding specs and elastic planning against the JAX
package, on the CPU.

  * ``resolve_spec`` / ``pspec_tree`` / ``fit_spec_to_shape`` equal the
    reference's, as tuples, for all ten configs at full size
    (``param_defs`` allocates nothing) and every shape's input defs, with
    ``use_fsdp`` and ``use_tp`` true and false and an explicit
    ``fsdp_axes``, on the (16, 16) and (2, 16, 16) production meshes.  The
    reference's ``fit_spec_to_shape`` gets a stand-in with ``axis_names``
    and ``devices`` of the mesh's shape; the port's gets a ``DeviceMesh``
    built by ``make_production_mesh`` on a fake world of 256 / 512 ranks
    (the fake backend, in a subprocess);
  * ``spec_placements`` lays a dimension sharded over ('pod', 'data') out
    as ``NamedSharding`` does: every rank of a fake 512-rank world holds
    the block of the full array that the same device of a 512-device jax
    mesh holds;
  * ``make_production_mesh`` refuses other world sizes; ``dp_axes_of``;
  * mirrors of ``tests/test_substrates.py``'s health-tracker and
    ``plan_mesh`` tests, and ``remesh``'s survivors.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_NAMES, SHAPES, get_config  # noqa: E402
from repro.launch.mesh import dp_axes_of as ref_dp_axes_of  # noqa: E402
from repro.launch.train import use_fsdp  # noqa: E402
from repro.models import ModelZoo  # noqa: E402
from repro.models.layers import (fit_spec_to_shape,  # noqa: E402
                                 pspec_tree, resolve_spec)

from repro_torch.ft import HealthTracker, plan_mesh  # noqa: E402
from torch_gloo import ROOT, run_fake  # noqa: E402

MESHES = {"single_pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}
# (use_fsdp, use_tp, fsdp_axes) for pspec_tree / resolve_spec
PROFILES = [(False, True, None), (True, True, None), (False, False, None),
            (True, False, None), (False, False, ("data", "model"))]


class StandInMesh:
    """What the reference's ``fit_spec_to_shape`` and ``dp_axes_of`` read
    of a ``jax.sharding.Mesh``."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.zeros(shape, dtype=object)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _json(spec):
    return json.loads(json.dumps(tuple(spec)))


def _reference_specs():
    """{mesh: {arch: {profile: {leaf: [spec, fitted]}}}}, and the input
    defs' per shape."""
    out = {}
    for mname, (shape, axes) in MESHES.items():
        mesh = StandInMesh(shape, axes)
        dp = ref_dp_axes_of(mesh)
        per = out[mname] = {}
        for arch in ARCH_NAMES:
            zoo = ModelZoo(get_config(arch))
            defs = _flat(zoo.param_defs())
            rows = per[arch] = {}
            for i, (fsdp, tp, fsdp_axes) in enumerate(PROFILES):
                if fsdp_axes is None:
                    specs = _flat(pspec_tree(zoo.param_defs(), use_fsdp=fsdp,
                                             dp_axes=dp, use_tp=tp))
                else:
                    specs = {k: resolve_spec(d.spec, use_fsdp=fsdp,
                                             dp_axes=dp, use_tp=tp,
                                             fsdp_axes=fsdp_axes)
                             for k, d in defs.items()}
                rows[str(i)] = {
                    k: [_json(s), _json(fit_spec_to_shape(defs[k].shape, s,
                                                          mesh))]
                    for k, s in specs.items()}
            # init_train_state's own choice: FSDP from 2 B parameters
            rows["auto"] = _flat(pspec_tree(
                zoo.param_defs(), use_fsdp=use_fsdp(get_config(arch)),
                dp_axes=dp))
            rows["auto"] = {k: _json(s) for k, s in rows["auto"].items()}
            inputs = rows["inputs"] = {}
            for sname, sh in SHAPES.items():
                for k, d in zoo.input_defs(sh).items():
                    s = resolve_spec(d.spec, use_fsdp=False, dp_axes=dp)
                    inputs[f"{sname}/{k}"] = [
                        _json(s), _json(fit_spec_to_shape(d.shape, s, mesh))]
    return out


PORT_SPECS = """
import json
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.launch import dp_axes_of, make_production_mesh, use_fsdp
from repro_torch.models import ModelZoo
from repro_torch.models.layers import fit_spec_to_shape, pspec_tree, resolve_spec
PROFILES = json.loads(PROFILES_JSON)

def flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out

out = {"dp": {}, "shapes": {}}
for mname, world in (("single_pod", 256), ("multi_pod", 512)):
    dist.init_process_group("fake", store=FakeStore(), rank=world - 1,
                            world_size=world)
    mesh = make_production_mesh(multi_pod=world == 512, device_type="cpu")
    out["shapes"][mname] = [list(mesh.shape), list(mesh.mesh_dim_names)]
    dp = dp_axes_of(mesh)
    out["dp"][mname] = list(dp)
    per = out[mname] = {}
    for arch in ARCH_NAMES:
        zoo = ModelZoo(get_config(arch))
        defs = flat(zoo.param_defs())
        rows = per[arch] = {}
        for i, (fsdp, tp, fsdp_axes) in enumerate(PROFILES):
            if fsdp_axes is None:
                specs = flat(pspec_tree(zoo.param_defs(), use_fsdp=fsdp,
                                        dp_axes=dp, use_tp=tp))
            else:
                specs = {k: resolve_spec(d.spec, use_fsdp=fsdp, dp_axes=dp,
                                         use_tp=tp,
                                         fsdp_axes=tuple(fsdp_axes))
                         for k, d in defs.items()}
            rows[str(i)] = {k: [s, fit_spec_to_shape(defs[k].shape, s, mesh)]
                            for k, s in specs.items()}
        rows["auto"] = flat(pspec_tree(
            zoo.param_defs(), use_fsdp=use_fsdp(get_config(arch)),
            dp_axes=dp))
        inputs = rows["inputs"] = {}
        for sname, sh in SHAPES.items():
            for k, d in zoo.input_defs(sh).items():
                s = resolve_spec(d.spec, use_fsdp=False, dp_axes=dp)
                inputs[f"{sname}/{k}"] = [s, fit_spec_to_shape(d.shape, s,
                                                               mesh)]
    dist.destroy_process_group()
print(json.dumps(out))
"""


def test_spec_trees_equal_the_reference_on_the_production_meshes():
    ref = _reference_specs()
    proc = run_fake(f"PROFILES_JSON = {json.dumps(PROFILES)!r}\n"
                    + PORT_SPECS)
    assert proc.returncode == 0, proc.stderr[-4000:]
    port = json.loads(proc.stdout)
    assert port["shapes"] == {k: [list(s), list(a)]
                              for k, (s, a) in MESHES.items()}
    for mname, (shape, axes) in MESHES.items():
        assert port["dp"][mname] == list(ref_dp_axes_of(
            StandInMesh(shape, axes)))
        port_m = json.loads(json.dumps(port[mname]))
        assert sorted(port_m) == sorted(ref[mname]) == ARCH_NAMES
        for arch in ARCH_NAMES:
            assert port_m[arch] == ref[mname][arch], (mname, arch)
    # both branches of use_fsdp were reached by full-size configs
    assert {use_fsdp(get_config(a)) for a in ARCH_NAMES} == {True, False}
    trimmed = [k for arch in ARCH_NAMES
               for k, (s, f) in ref["multi_pod"][arch]["inputs"].items()
               if s != f]
    assert trimmed, "no input dim was trimmed by fit_spec_to_shape"


LAYOUT = """
import json
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from repro_torch.launch import make_production_mesh
from repro_torch.models.layers import spec_placements
SHAPE = (512, 576)
SPECS = [[["pod", "data"], "model"], ["model", ["pod", "data"]],
         [["pod", "data", "model"], None], [None, "data"]]
out = {}
for rank in range(512):
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=512)
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    for i, spec in enumerate(SPECS):
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        shape, offset = compute_local_shape_and_global_offset(
            SHAPE, mesh, spec_placements(spec, mesh))
        out[f"{i}/{rank}"] = [[o, o + n] for o, n in zip(offset, shape)]
    dist.destroy_process_group()
print(json.dumps(out))
"""

JAX_LAYOUT = """
import json
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
SHAPE = (512, 576)
SPECS = [P(("pod", "data"), "model"), P("model", ("pod", "data")),
         P(("pod", "data", "model"), None), P(None, "data")]
devs = sorted(jax.devices(), key=lambda d: d.id)
mesh = Mesh(np.array(devs).reshape(2, 16, 16), ("pod", "data", "model"))
out = {}
for i, spec in enumerate(SPECS):
    for d, idx in NamedSharding(mesh, spec).devices_indices_map(SHAPE).items():
        out[f"{i}/{d.id}"] = [[s.start or 0, SHAPE[k] if s.stop is None
                               else s.stop] for k, s in enumerate(idx)]
print(json.dumps(out))
"""


def test_two_axis_shards_lay_out_as_named_sharding():
    port = run_fake(LAYOUT)
    assert port.returncode == 0, port.stderr[-4000:]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    ref = subprocess.run([sys.executable, "-c", JAX_LAYOUT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert ref.returncode == 0, ref.stderr[-4000:]
    got, want = json.loads(port.stdout), json.loads(ref.stdout)
    assert len(got) == len(want) == 4 * 512
    assert got == want


def test_production_mesh_refuses_other_world_sizes():
    proc = run_fake("""
        import json
        from repro_torch.launch import dp_axes_of, make_production_mesh
        errors = []
        for world, multi_pod in ((8, False), (256, True), (512, False)):
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=world)
            try:
                make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            except ValueError as e:
                errors.append(str(e))
            dist.destroy_process_group()
        try:
            make_production_mesh(device_type="cpu")  # no world at all
        except ValueError as e:
            errors.append(str(e))
        dist.init_process_group("fake", store=FakeStore(), rank=3,
                                world_size=256)
        mesh = make_production_mesh(device_type="cpu")
        print(json.dumps(dict(errors=errors, dp=dp_axes_of(mesh),
                              coord=mesh.get_coordinate())))
    """)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout)
    assert len(out["errors"]) == 4
    assert all("needs a world of" in e for e in out["errors"])
    assert out["dp"] == ["data"] and out["coord"] == [0, 3]


def test_mesh_from_ranks_and_remesh_of_survivors():
    """``make_mesh_from_devices`` reshapes the ranks it is given;
    ``remesh`` keeps the first data·model survivors."""
    proc = run_fake("""
        import json
        from repro_torch.ft import remesh
        from repro_torch.launch import dp_axes_of, make_mesh_from_devices
        dist.init_process_group("fake", store=FakeStore(), rank=2,
                                world_size=8)
        m = make_mesh_from_devices([7, 6, 5, 4, 3, 2, 1, 0], (2, 2, 2),
                                   ("pod", "data", "model"),
                                   device_type="cpu")
        r = remesh([0, 1, 2, 3, 4, 5, 6], model_size=2, device_type="cpu")
        print(json.dumps(dict(mesh=m.mesh.tolist(), dp=dp_axes_of(m),
                              coord=m.get_coordinate(), r=r.mesh.tolist(),
                              names=r.mesh_dim_names)))
    """)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout)
    assert out["mesh"] == [[[7, 6], [5, 4]], [[3, 2], [1, 0]]]
    assert out["dp"] == ["pod", "data"] and out["coord"] == [1, 0, 1]
    assert out["r"] == [[0, 1], [2, 3], [4, 5]]
    assert out["names"] == ["data", "model"]


def test_spec_placements_refuse_axes_out_of_mesh_order():
    proc = run_fake("""
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.launch import make_mesh_from_devices
        from repro_torch.models.layers import spec_placements
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
        m = make_mesh_from_devices(range(8), (2, 2, 2),
                                   ("pod", "data", "model"),
                                   device_type="cpu")
        assert spec_placements((("pod", "data"), "model"), m) == (
            Shard(0), Shard(0), Shard(1))
        assert spec_placements((None, None), m) == (Replicate(),) * 3
        for bad in ((("data", "pod"), None), ("data", "data")):
            try:
                spec_placements(bad, m)
            except ValueError:
                continue
            raise AssertionError(bad)
        print("OK")
    """)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip() == "OK"


def test_health_tracker_detects_failure():
    ht = HealthTracker(num_hosts=4, timeout_s=5.0)
    for h in range(4):
        ht.heartbeat(h, t=0.0)
    ht.advance(3.0)
    for h in (0, 1, 2):
        ht.heartbeat(h)
    ht.advance(3.0)
    assert ht.failed_hosts() == [3]
    assert ht.alive_hosts() == [0, 1, 2]


def test_plan_mesh_keeps_model_axis():
    from repro.ft import plan_mesh as ref_plan_mesh
    assert plan_mesh(512, 16) == (32, 16)
    assert plan_mesh(496, 16) == (31, 16)  # one host of 16 lost
    with pytest.raises(ValueError):
        plan_mesh(8, 16)
    for n in (1, 2, 7, 16, 255, 256, 496, 512):
        for m in (1, 2, 16):
            if n >= m:
                assert plan_mesh(n, m) == ref_plan_mesh(n, m)
