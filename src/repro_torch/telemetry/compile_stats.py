"""Build and launch counts per lane, for no-rebuild assertions.

Port of ``repro.telemetry.compile_stats``.  The reference counts JAX
jit-cache entries per lane; PyTorch runs eagerly, so the port counts what
it does build and launch instead:

* :func:`compile_stats` — ``"builds"``: kernel libraries compiled by
  ``nvcc`` in this process; ``"loaded"``: libraries loaded;
  ``"fused"`` / ``"tiled"`` / ``"sparse"``: kernel variants the wrappers
  have selected,
  keyed by (record_beta, record_watermarks, record_guard) — on a CPU
  tensor a wrapper selects the same key before it runs the plain version.
* :func:`launch_counts` — ``"fused"`` / ``"tiled"`` / ``"sparse"``: calls
  of each kernel wrapper that launched on the card; ``"segment-sum"``:
  runs of the segment-sum period loop.

:class:`no_new_compiles` keeps the reference's meaning: a gain, latency,
mask, ``lamsum`` or ELL-table sweep (a chaos campaign's per-draw victims
and magnitudes included) builds and selects nothing new.

Engine modules are imported inside the functions, so this module stays
importable before the kernel stack.
"""
from __future__ import annotations

__all__ = ["compile_stats", "launch_counts", "no_new_compiles"]


def compile_stats() -> dict:
    """Builds, loaded libraries and selected kernel instances so far."""
    from repro_torch.kernels import bittide_step, build
    used = bittide_step.VARIANTS_USED
    return {"builds": build.BUILD_COUNT["nvcc"],
            "loaded": build.BUILD_COUNT["loaded"],
            "fused": sum(1 for v in used if v[0] == "fused"),
            "tiled": sum(1 for v in used if v[0] == "tiled"),
            "sparse": sum(1 for v in used if v[0] == "sparse")}


def launch_counts() -> dict:
    """Kernel launches (fused, tiled, sparse) and period-loop runs
    (segment-sum)."""
    from repro_torch.core.frame_model import RUN_COUNT
    from repro_torch.kernels.bittide_sparse import bittide_sparse
    from repro_torch.kernels.bittide_step import bittide_fused, bittide_tiled
    return {"fused": bittide_fused.launches, "tiled": bittide_tiled.launches,
            "sparse": bittide_sparse.launches,
            "segment-sum": RUN_COUNT["segment-sum"]}


class no_new_compiles:
    """Context manager pinning the build budget of a block::

        with no_new_compiles():          # nothing new built or selected
            simulate_ensemble_dense(...) # (a gain sweep)

        with no_new_compiles(fused=1):   # exactly one new variant allowed
            ...

    Keys are :func:`compile_stats` keys; unnamed keys must stay flat.
    """

    def __init__(self, **budget: int):
        unknown = set(budget) - set(compile_stats())
        if unknown:
            raise KeyError(f"unknown compile-stat keys: {sorted(unknown)}")
        self.budget = budget

    def __enter__(self):
        self.before = compile_stats()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        after = compile_stats()
        for k, n0 in self.before.items():
            allowed = self.budget.get(k, 0)
            grew = after[k] - n0
            if grew > allowed:
                raise AssertionError(
                    f"{k} grew by {grew}, budget {allowed}")
        return False
