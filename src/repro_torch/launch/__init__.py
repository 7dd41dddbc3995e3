"""The launcher of the port (``repro.launch``): device meshes
(``launch.mesh``), the train / serve step builders and the training
state, on one device or a mesh (``launch.train``).  The launch analysis
(``memmodel``, ``roofline``, ``hloanalysis``, ``dryrun``) waits for its
slice (``ROADMAP.md`` queue 1)."""
from .mesh import dp_axes_of, make_mesh_from_devices, make_production_mesh
from .train import (init_train_state, lr_schedule, make_decode_step,
                    make_prefill_step, make_train_step, state_shardings,
                    use_fsdp, value_and_grad)

__all__ = ["dp_axes_of", "make_mesh_from_devices", "make_production_mesh",
           "init_train_state", "lr_schedule", "make_decode_step",
           "make_prefill_step", "make_train_step", "state_shardings",
           "use_fsdp", "value_and_grad"]
