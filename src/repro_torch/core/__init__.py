"""bittide core on PyTorch (port of ``repro.core``, slice 1).

  topology     network graphs (numpy copy of the reference's builders)
  controller   proportional / discrete FINC-FDEC / PI control on tensors
  frame_model  the abstract frame model: the segment-sum lane
               (``simulate`` / ``simulate_ensemble``)
"""
from . import controller, frame_model, topology
from .controller import (ControllerConfig, controller_init, controller_step,
                         hardware_gain, holdover_freeze)
from .frame_model import (EB_INIT, OMEGA_NOM, PIPE_FRAMES, SIGNAL_VELOCITY,
                          EnsembleResult, LinkParams, SimConfig, SimResult,
                          broadcast_gain, make_links, simulate,
                          simulate_ensemble)
from .topology import (Topology, cube, from_links, fully_connected,
                       hourglass, line, mesh2d, random_regular, ring, star,
                       torus3d)
