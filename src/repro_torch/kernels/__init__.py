"""Hand-written Hopper kernels and their runners (port of ``repro.kernels``).

bittide_step  the dense engines: ``bittide_fused`` (CUDA kernel
              ``csrc/bittide_fused.cu``), ``bittide_tiled``
              (``csrc/bittide_tiled.cu``) and the per-step
              ``bittide_perstep`` (``csrc/bittide_step.cu``, one draw, one
              launch per period), launch-counted wrappers, their plain
              PyTorch versions and the H100 ``select_engine``
bittide_sparse the sparse ELL engine: ``ellify`` / ``max_in_degree``
              (host table builder), ``bittide_sparse`` (CUDA kernel
              ``csrc/bittide_sparse.cu``) and its plain version
build         nvcc build of ``csrc/*.cu`` into ctypes-loaded libraries
ops           densify + the dense, sparse and per-step runners returning
              DenseResult, and ``bittide_step`` (one period of one draw)
ref           plain-torch dense oracle (``use_ref=True``)
api           EngineOptions / EngineOutputs
"""
from .api import EngineOptions, EngineOutputs
# The sparse wrapper is reached as bittide_sparse.bittide_sparse: a
# package-level name would shadow its module.
from .bittide_sparse import bittide_sparse_torch, ellify, max_in_degree
from .bittide_step import (FUSED_N_MAX, KERNEL_N_MAX, TILE_J, bittide_fused,
                           bittide_fused_torch, bittide_perstep,
                           bittide_perstep_torch, bittide_tiled,
                           bittide_tiled_torch, select_engine)
# The one-period API is reached as ops.bittide_step: a package-level name
# would shadow the bittide_step module.
from .ops import (DenseResult, densify, latency_classes, simulate_dense,
                  simulate_dense_perstep, simulate_ensemble_dense,
                  simulate_fused)
from .ref import (bittide_dense_multistep_ref, bittide_dense_step_ref,
                  node_occupancy_ref, occupancy_ref)
