"""Run a snippet of Python in several fresh processes that form one
``torch.distributed`` world on the CPU (the gloo backend), or in one
process on a fake world of any size (the fake backend: no data moves).

The processes rendezvous on a ``FileStore`` in a directory the caller
gives (a pytest ``tmp_path``), so parallel test workers never share a
port; every group and every process has a time limit, so a hung
collective fails the test instead of holding the suite.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

GLOO_PREAMBLE = """\
import datetime, os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK = int(os.environ["RANK"])
WORLD = int(os.environ["WORLD_SIZE"])
dist.init_process_group(
    "gloo", init_method="file://" + os.environ["STORE"], rank=RANK,
    world_size=WORLD, timeout=datetime.timedelta(seconds=60))
"""

# After the snippet: every rank meets at a barrier and destroys its
# groups; a rank that got this far leaves by os._exit(0).  In a process
# that ran point-to-point ops and then a collective on a DeviceMesh
# group, gloo can abort in the interpreter's own teardown, after
# destroy_process_group has returned ("terminate called without an
# active exception": 2 of 128 four-rank pipeline worlds under load on
# this CPU, none of 128 with the exit).  A snippet that raises still
# exits 1 with its traceback.
GLOO_EPILOGUE = """
    dist.barrier()
finally:
    dist.destroy_process_group()
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
"""

FAKE_PREAMBLE = """\
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]),
        OMP_NUM_THREADS="1", **extra)
    env.pop("XLA_FLAGS", None)
    return env


def run_ranks(code: str, world: int, workdir: Path, timeout: float = 240):
    """Run ``code`` (after :data:`GLOO_PREAMBLE`; ``RANK``, ``WORLD`` and
    ``WORKDIR`` are defined) as ranks 0..world-1 of one gloo world.
    Returns each rank's (returncode, stdout, stderr); a rank still
    running at ``timeout`` seconds is killed and reported as -9."""
    workdir = Path(workdir)
    store = workdir / f"store_{world}_{os.getpid()}_{id(code)}"
    body = (GLOO_PREAMBLE + f"WORKDIR = {str(workdir)!r}\n"
            + "try:\n" + textwrap.indent(textwrap.dedent(code), "    ")
            + GLOO_EPILOGUE)
    procs = [subprocess.Popen(
        [sys.executable, "-c", body], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=_env(RANK=str(r), WORLD_SIZE=str(world), STORE=str(store)))
        for r in range(world)]
    out = []
    for p in procs:
        try:
            o, e = p.communicate(timeout=timeout)
            out.append((p.returncode, o, e))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            o, e = p.communicate()
            out.append((-9, o, e + "\n[killed at the time limit]"))
    return out


def assert_ranks_ok(results):
    for rank, (rc, o, e) in enumerate(results):
        assert rc == 0, f"rank {rank} exited {rc}\n{o[-2000:]}\n{e[-4000:]}"


def run_fake(code: str, timeout: float = 120):
    """Run ``code`` (after :data:`FAKE_PREAMBLE`) in one process, which
    may open fake worlds of any size.  Returns the CompletedProcess."""
    body = FAKE_PREAMBLE + textwrap.dedent(code)
    return subprocess.run([sys.executable, "-c", body], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout,
                          env=_env())
