"""The port's distributed training path against the JAX package, on gloo
CPU worlds (mirrors of ``tests/test_multidevice.py``).

The reference forces 8 host devices into one process; the port's ranks
are processes, each a fresh Python that imports torch, so these worlds
hold 4 ranks (2 for the survivors).  Each world runs in subprocesses
(``tests/torch_gloo.py``: a ``FileStore`` under ``tmp_path``, a 60 s
group timeout, a time limit per process); inputs cross as ``.npz``.

  * ``sched.pipeline_apply`` over 4 stages against the sequential chain
    at rtol / atol 1e-5, as ``test_bittide_scheduled_pipeline_matches_sequential``;
    its plan equal to ``repro.sched.plan``'s;
  * ``compressed_psum`` over 4 ranks: each rank's residual bit-equal to
    the reference's ``ef_roundtrip`` of its shard; the mean within f32
    rounding of the mean of the reference's payloads and within 0.05 of
    the true mean, as ``test_compressed_psum_multidevice``;
  * elastic remesh and resume on reduced smollm-135m, as
    ``test_elastic_remesh_and_resume``: a (2, 2) world of 4 takes 3 steps
    of ``make_train_step`` on a mesh, saves, takes a fourth; a fresh world
    of 2 survivors re-meshes to (1, 2), restores with ``shardings`` bit for
    bit and takes the fourth step.  The reference's weights come across by
    ``convert.model_params`` and its batches as numpy; every loss is within
    the reference's 5e-4 of its own single-device jitted steps;
  * on a one-rank mesh the step equals the plain step bit for bit.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_gloo import assert_ranks_ok, run_ranks  # noqa: E402

PIPE_TOL = 1e-5          # tests/test_multidevice.py:47
PSUM_TRUE_TOL = 0.05     # tests/test_multidevice.py:166
ELASTIC_LOSS_TOL = 5e-4  # tests/test_multidevice.py:115
# The reference's step numbers for lr_schedule: past the warm-up, so
# that the four updates move the loss.
STEP0 = 1_000


def test_pipeline_apply_matches_sequential_over_four_stages(tmp_path):
    from repro.core import make_links, ring
    from repro.core.latency import logical_latency
    from repro.core.schedule import LogicalSynchronyNetwork
    from repro.sched import plan
    S, M, D = 4, 6, 16
    rng = np.random.default_rng(0)
    ws = rng.normal(0, 0.5, (S, D, D)).astype(np.float32)
    x = rng.normal(0, 1, (M, 2, D)).astype(np.float32)
    np.savez(tmp_path / "in.npz", ws=ws, x=x)
    res = run_ranks(f"""
        import json
        import numpy as np
        from repro_torch.core import make_links, ring
        from repro_torch.core.latency import logical_latency
        from repro_torch.core.schedule import LogicalSynchronyNetwork
        from repro_torch.launch import make_mesh_from_devices
        from repro_torch.sched import pipeline_apply, plan
        d = np.load(WORKDIR + "/in.npz")
        mesh = make_mesh_from_devices(range({S}), ({S},), ("stage",),
                                      device_type="cpu")
        out = pipeline_apply(lambda w, h: torch.tanh(h @ w),
                             torch.from_numpy(d["ws"]),
                             torch.from_numpy(d["x"]), mesh, "stage", {M})
        np.save(WORKDIR + f"/out{{RANK}}.npy", out.numpy())
        topo = ring({S})
        lsn = LogicalSynchronyNetwork(topo, logical_latency(topo,
                                                            make_links(topo)))
        p = plan(lsn, list(range({S})), {M}, fwd_ticks=100, bwd_ticks=0,
                 activation_frames=8)
        events = [(e.src, e.dst, e.send_tick, e.recv_tick, e.frames, e.tag)
                  for e in p.schedule.events]
        if RANK == 0:
            with open(WORKDIR + "/plan.json", "w") as f:
                json.dump(dict(makespan=p.makespan_ticks,
                               bubble=p.bubble_fraction, bounded=p.bounded,
                               events=events), f)
    """, S, tmp_path)
    assert_ranks_ok(res)
    ref = jnp.asarray(x)
    for s in range(S):
        ref = jnp.tanh(ref @ ws[s])
    for r in range(S):   # every rank returns the outputs
        np.testing.assert_allclose(np.load(tmp_path / f"out{r}.npy"),
                                   np.asarray(ref), rtol=PIPE_TOL,
                                   atol=PIPE_TOL)
    topo = ring(S)
    lsn = LogicalSynchronyNetwork(topo, logical_latency(topo,
                                                        make_links(topo)))
    p = plan(lsn, list(range(S)), M, fwd_ticks=100, bwd_ticks=0,
             activation_frames=8)
    got = json.loads((tmp_path / "plan.json").read_text())
    assert p.bounded and got["bounded"]
    assert got["makespan"] == p.makespan_ticks
    assert got["bubble"] == p.bubble_fraction
    assert [tuple(e) for e in got["events"]] == [
        (e.src, e.dst, e.send_tick, e.recv_tick, e.frames, e.tag)
        for e in p.schedule.events]


def test_compressed_psum_over_four_ranks(tmp_path):
    from repro.optim.compression import ef_roundtrip
    n = 4
    rng = np.random.default_rng(0)
    g = rng.normal(0, 1, (n, 16)).astype(np.float32)
    e = rng.normal(0, 0.01, (n, 16)).astype(np.float32)
    np.savez(tmp_path / "in.npz", g=g, e=e)
    res = run_ranks("""
        import numpy as np
        from repro_torch.launch import make_mesh_from_devices
        from repro_torch.optim.compression import compressed_psum
        d = np.load(WORKDIR + "/in.npz")
        mesh = make_mesh_from_devices(range(WORLD), (WORLD,), ("dp",),
                                      device_type="cpu")
        g = torch.from_numpy(d["g"][RANK])
        e = torch.from_numpy(d["e"][RANK])
        mean, new_e = compressed_psum(g, e, (mesh, "dp"))
        # a process group works as well as a (mesh, axis) pair
        mean2, new_e2 = compressed_psum(g, e, mesh.get_group("dp"))
        assert torch.equal(mean, mean2) and torch.equal(new_e, new_e2)
        np.savez(WORKDIR + f"/out{RANK}.npz", mean=mean.numpy(),
                 new_e=new_e.numpy())
    """, n, tmp_path)
    assert_ranks_ok(res)
    payloads = []
    for r in range(n):
        deq, ref_e = ef_roundtrip(jnp.asarray(g[r]), jnp.asarray(e[r]))
        payloads.append(np.asarray(deq))
        got = np.load(tmp_path / f"out{r}.npz")
        np.testing.assert_array_equal(got["new_e"].view(np.int32),
                                      np.asarray(ref_e).view(np.int32))
    payloads = np.stack(payloads)
    ref_mean = payloads.sum(0) / np.float32(n)
    # f32 rounding of a sum of n terms, in any order
    bar = n * np.finfo(np.float32).eps * np.abs(payloads).sum(0) / n
    means = [np.load(tmp_path / f"out{r}.npz")["mean"] for r in range(n)]
    for m in means:
        np.testing.assert_array_equal(m, means[0])
        assert (np.abs(m - ref_mean) <= bar).all()
        assert np.abs(m - g.mean(0)).max() < PSUM_TRUE_TOL


def _reference_run(cfg, n_steps, data):
    """The reference's own single-device jitted ``make_train_step`` from
    ``materialize(PRNGKey(0))``: the initial parameters (numpy) and the
    loss of each step."""
    from repro.launch.train import make_train_step
    from repro.models import ModelZoo
    from repro.models.layers import materialize
    from repro.optim import AdamWConfig, adamw_init
    zoo = ModelZoo(cfg)
    opt = AdamWConfig(lr=1e-2)
    params = materialize(zoo.param_defs(), jax.random.PRNGKey(0),
                         jnp.float32)
    init = jax.tree.map(np.asarray, params)
    state = adamw_init(params, opt)
    step = jax.jit(make_train_step(cfg, opt))
    losses = []
    for n in range(n_steps):
        params, state, m = step(params, state, data.batch(n), STEP0 + n)
        losses.append(float(m["loss"]))
    return init, losses


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# What each world runs: the reference's initial weights and batches from
# WORKDIR/in.npz, the port's make_train_step on a mesh.
ELASTIC_SETUP = """
    import json
    import numpy as np
    from repro_torch import convert
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.ft import plan_mesh, remesh
    from repro_torch.launch import make_train_step, state_shardings
    from repro_torch.optim import AdamWConfig, adamw_init
    from torch.distributed.tensor import distribute_tensor
    d = np.load(WORKDIR + "/in.npz")
    cfg = get_config("smollm-135m").reduced()
    opt = AdamWConfig(lr=1e-2)

    def unflat(prefix):
        tree = {}
        for k in d.files:
            if k.startswith(prefix):
                node = tree
                *path, leaf = k[len(prefix):].split("/")
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = d[k]
        return tree

    def batch(n):
        return {k: torch.from_numpy(d[f"batch{n}/{k}"])
                for k in ("tokens", "labels")}

    shardings = lambda mesh: state_shardings(cfg, mesh)

    step = make_train_step(cfg, opt)
    mgr = CheckpointManager(WORKDIR + "/ckpt")
"""


def test_elastic_remesh_and_resume(tmp_path):
    """4 ranks (2 data x 2 model) train, checkpoint, take a fourth step;
    2 survivors re-mesh to (1, 2), restore bit for bit, resume."""
    from repro.configs import get_config
    from repro.data import DataConfig, SyntheticPipeline
    cfg = get_config("smollm-135m").reduced()
    data = SyntheticPipeline(DataConfig(cfg.vocab_size, 32, 8, seed=1))
    init, ref_losses = _reference_run(cfg, 4, data)
    arrays = {f"params/{k}": v for k, v in _flat(init).items()}
    for n in range(4):
        for k, v in data.batch(n).items():
            arrays[f"batch{n}/{k}"] = np.asarray(v)
    np.savez(tmp_path / "in.npz", **arrays)

    res = run_ranks(ELASTIC_SETUP + f"""
    mesh = remesh(list(range(WORLD)), model_size=2, device_type="cpu")
    assert tuple(mesh.shape) == (2, 2), mesh
    params = convert.model_params(unflat("params/"), device="cpu")
    state = {{"params": params, "opt": adamw_init(params, opt)}}
    state = tree_map(lambda t, sh: distribute_tensor(t, *sh), state,
                     shardings(mesh))
    p, o = state["params"], state["opt"]
    losses = []
    for n in range(3):
        p, o, m = step(p, o, batch(n), {STEP0} + n)
        losses.append(float(m["loss"]))
    saved = {{"params": p, "opt": o}}
    mgr.save(3, saved)
    full = [t.full_tensor() for t in tree_leaves(saved)]
    p, o, m = step(p, o, batch(3), {STEP0} + 3)
    losses.append(float(m["loss"]))
    if RANK == 0:
        torch.save(full, WORKDIR + "/saved.pt")
        with open(WORKDIR + "/world4.json", "w") as f:
            json.dump(dict(losses=losses, all_reduces=m["all_reduces"]), f)
    """, 4, tmp_path)
    assert_ranks_ok(res)

    res = run_ranks(ELASTIC_SETUP + f"""
    survivors = list(range(WORLD))
    assert plan_mesh(len(survivors), 2) == (1, 2)
    mesh = remesh(survivors, model_size=2, device_type="cpu")
    template = {{"params": convert.model_params(unflat("params/"),
                                               device="cpu")}}
    template["opt"] = adamw_init(template["params"], opt)
    n, state = mgr.restore_latest(template, shardings(mesh))
    assert n == 3
    saved = torch.load(WORKDIR + "/saved.pt")
    same = [bool(torch.equal(a.full_tensor(), b))
            for a, b in zip(tree_leaves(state), saved)]
    local_ok = all(t.device_mesh is mesh for t in tree_leaves(state))
    p, o, m = step(state["params"], state["opt"], batch(3), {STEP0} + 3)
    if RANK == 0:
        with open(WORKDIR + "/world2.json", "w") as f:
            json.dump(dict(same=same, on_new_mesh=local_ok,
                           loss=float(m["loss"])), f)
    """, 2, tmp_path)
    assert_ranks_ok(res)
    w4 = json.loads((tmp_path / "world4.json").read_text())
    w2 = json.loads((tmp_path / "world2.json").read_text())
    # every parameter, both moments of each, and the count
    assert all(w2["same"]) and len(w2["same"]) == 3 * len(_flat(init)) + 1
    assert w2["on_new_mesh"]
    # one all-reduce per gradient leaf and the loss, over the one data axis
    assert w4["all_reduces"] == len(_flat(init)) + 1
    for got, want in zip(w4["losses"], ref_losses):
        assert abs(got - want) < ELASTIC_LOSS_TOL, (w4["losses"], ref_losses)
    assert abs(w2["loss"] - ref_losses[3]) < ELASTIC_LOSS_TOL
    assert abs(w2["loss"] - w4["losses"][3]) < ELASTIC_LOSS_TOL
    # the losses move: past the warm-up the updates are not negligible
    assert abs(ref_losses[3] - ref_losses[0]) > 10 * ELASTIC_LOSS_TOL


def test_one_rank_mesh_step_equals_plain_step(tmp_path):
    """A (1, 1) mesh: the mesh step's loss, parameters and moments equal
    the plain step's bit for bit over three steps, with a batch that the
    data axis splits and one it cannot (fit_spec_to_shape's rule)."""
    res = run_ranks("""
        from repro_torch._tree import tree_leaves
        from repro_torch.configs import get_config
        from repro_torch.data import DataConfig, SyntheticPipeline
        from repro_torch.ft import remesh
        from repro_torch.launch import init_train_state, make_train_step
        cfg = get_config("smollm-135m").reduced()
        mesh = remesh([0], model_size=1, device_type="cpu")
        p_m, o_m = init_train_state(cfg, mesh,
                                    torch.Generator().manual_seed(0))
        p, o = init_train_state(cfg, None, torch.Generator().manual_seed(0),
                                device="cpu")
        step = make_train_step(cfg)
        data = SyntheticPipeline(DataConfig(cfg.vocab_size, 32, 3, seed=2))
        bits = lambda t: t.view(torch.int32) if t.is_floating_point() else t
        for n in range(3):
            batch = data.batch(n, device="cpu")
            p_m, o_m, mm = step(p_m, o_m, batch, n)
            p, o, m = step(p, o, batch, n)
            assert torch.equal(bits(mm["loss"]), bits(m["loss"])), n
            assert torch.equal(mm["grad_norm"], m["grad_norm"]), n
            for a, b in zip(tree_leaves({"p": p_m, "o": o_m}),
                            tree_leaves({"p": p, "o": o})):
                assert torch.equal(bits(a.full_tensor()), bits(b)), n
        print("ONE_RANK_OK")
    """, 1, tmp_path)
    assert_ranks_ok(res)
    assert "ONE_RANK_OK" in res[0][1]
