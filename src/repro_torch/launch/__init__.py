"""The launcher of the port (``repro.launch``): the train / serve step
builders and the training state (``launch.train``).  The mesh, the dry
run and the launch analysis modules wait for their slices
(``ROADMAP.md`` queue 1)."""
from .train import (init_train_state, lr_schedule, make_decode_step,
                    make_prefill_step, make_train_step, use_fsdp,
                    value_and_grad)

__all__ = ["init_train_state", "lr_schedule", "make_decode_step",
           "make_prefill_step", "make_train_step", "use_fsdp",
           "value_and_grad"]
