"""Hand-written Hopper kernels and their runners (port of ``repro.kernels``).

bittide_step  the fused multi-period engine: ``bittide_fused`` (CUDA
              kernel ``csrc/bittide_fused.cu``, launch-counted wrapper),
              its plain PyTorch version ``bittide_fused_torch`` and the
              H100 ``select_engine``
build         nvcc build of ``csrc/*.cu`` into ctypes-loaded libraries
ops           densify + the fused-lane runners returning DenseResult
ref           plain-torch dense oracle (``use_ref=True``)
api           EngineOptions / EngineOutputs
"""
from .api import EngineOptions, EngineOutputs
from .bittide_step import (FUSED_N_MAX, KERNEL_N_MAX, bittide_fused,
                           bittide_fused_torch, select_engine)
from .ops import (DenseResult, densify, latency_classes, simulate_dense,
                  simulate_ensemble_dense, simulate_fused)
from .ref import (bittide_dense_multistep_ref, bittide_dense_step_ref,
                  node_occupancy_ref, occupancy_ref)
