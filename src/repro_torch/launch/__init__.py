"""The launcher of the port (``repro.launch``): device meshes
(``launch.mesh``), the train / serve step builders, the training state
and the steps' abstract arguments, on one device or a mesh
(``launch.train``), and the launch analysis: the analytic HBM model
(``memmodel``), the collective, FLOP and byte counters
(``hloanalysis``), the dry run on fake tensors and fake worlds
(``dryrun``) and its tables (``roofline``)."""
from .mesh import dp_axes_of, make_mesh_from_devices, make_production_mesh
from .train import (abstract_serve_args, abstract_train_args,
                    init_train_state, lr_schedule, make_decode_step,
                    make_prefill_step, make_train_step, state_shardings,
                    use_fsdp, value_and_grad, widen_mesh_caches)

__all__ = ["dp_axes_of", "make_mesh_from_devices", "make_production_mesh",
           "abstract_serve_args", "abstract_train_args",
           "init_train_state", "lr_schedule", "make_decode_step",
           "make_prefill_step", "make_train_step", "state_shardings",
           "use_fsdp", "value_and_grad", "widen_mesh_caches"]
