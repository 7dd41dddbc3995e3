"""Helpers of the example tests (``tests/test_torch_examples_*.py``).

An example of either package runs in this process with its standard
output captured: the port's ``examples/torch_<name>.py`` and the
reference's ``examples/<name>.py`` through ``main(argv)``, or, where the
reference's ``main`` takes no argument, through ``runpy.run_path`` with
``sys.argv`` set.  The port prints one line naming its device, then the
reference's lines in the reference's order; ``assert_same_lines`` holds
the two texts to each other: the same words, and every number within
one unit of the last digit the reference printed.
"""
import contextlib
import importlib.util
import io
import re
import runpy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
# A printed number: not part of a name ("torus3d", "step_0003", "p50"),
# but after "x" ("x0.9999", the throughput ratio).
NUMBER = re.compile(r"(?<![A-WYZa-wyz_\d.])[-+]?(?:\d+\.?\d*|\.\d+)"
                    r"(?:[eE][-+]?\d+)?")


@contextlib.contextmanager
def one_torch_thread():
    """Run the port's eager loops on one intra-op thread: with six
    pytest-xdist workers on the host, each op's thread team over small
    tensors waits on the other workers' (a scale_torus test ran 85
    times slower)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def load(name: str):
    """``examples/<name>.py`` as a module (not run as a script)."""
    path = EXAMPLES / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chip_smoke():
    """``chip_smoke.py`` as a module (its card-side helpers and bars)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(mod, argv):
    """``mod.main(argv)`` with stdout captured: (its value, its lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = mod.main(argv)
    return value, buf.getvalue().splitlines()


def run_port(name: str, argv, mod=None):
    """The port's example on the CPU: (its dict, the lines after its
    device line)."""
    value, lines = run_main(mod or load(f"torch_{name}"),
                            [*argv, "--device", "cpu"])
    assert lines[0] == "device: cpu", lines[0]
    return value, lines[1:]


def run_script(name: str, argv):
    """A reference example whose ``main`` takes no argument, run as a
    script with ``sys.argv`` set: its printed lines."""
    path = str(EXAMPLES / f"{name}.py")
    buf = io.StringIO()
    old = sys.argv
    sys.argv = [path, *argv]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = old
    return buf.getvalue().splitlines()


def numbers(line: str):
    """The numbers printed on ``line``, as their tokens."""
    return NUMBER.findall(line)


def unit(token: str) -> float:
    """One unit of the last digit of a printed number."""
    mant, _, exp = token.lower().partition("e")
    decimals = len(mant.partition(".")[2])
    return 10.0 ** (-decimals + (int(exp) if exp else 0))


def assert_printed(value: float, token: str, what: str = ""):
    """``value`` lies within one unit of the last digit of ``token``."""
    assert abs(float(value) - float(token)) <= unit(token) * (1 + 1e-9), \
        f"{what}: {value} against the printed {token}"


def assert_same_lines(port, ref, reworded=(), masks=()):
    """The port's lines (after its device line) against the reference's,
    line for line: the same text with the numbers taken out, and each
    number within one unit of the reference's last digit.  Lines whose
    reference index is in ``reworded`` say in the port's words what the
    reference says of its compiler (their numbers are checked by the
    caller); each regex of ``masks`` (walls, rates) is blanked in both
    lines first."""
    assert len(port) == len(ref), (port, ref)
    for i, (p, r) in enumerate(zip(port, ref)):
        if i in reworded:
            continue
        for m in masks:
            p, r = re.sub(m, "<masked>", p), re.sub(m, "<masked>", r)
        assert NUMBER.sub("#", p) == NUMBER.sub("#", r), (i, p, r)
        for a, b in zip(numbers(p), numbers(r)):
            assert_printed(float(a), b, f"line {i}: {p!r} / {r!r}")
