"""bittide core on PyTorch (port of ``repro.core``).

  topology     network graphs (numpy copy of the reference's builders)
  controller   proportional / discrete FINC-FDEC / PI control on tensors
  frame_model  the abstract frame model: the segment-sum lane
               (``simulate`` / ``simulate_ensemble``)
  envelopes    closed-form occupancy step-response envelopes and the
               reframing guard margins (numpy copy)
  reframing    frame rotation: RTT-conserving pointer shifts (numpy copy)
"""
from . import controller, envelopes, frame_model, reframing, topology
from .controller import (ControllerConfig, controller_init, controller_step,
                         hardware_gain, holdover_freeze)
from .envelopes import (EnvelopeSpec, check_occupancy_envelope,
                        freq_step_envelope, latency_step_envelope)
from .frame_model import (EB_INIT, OMEGA_NOM, PIPE_FRAMES, SIGNAL_VELOCITY,
                          EnsembleResult, LinkParams, SimConfig, SimResult,
                          broadcast_gain, make_links, simulate,
                          simulate_ensemble)
from .reframing import (ReframePolicy, ReframeResult, reframe, reframe_net,
                        reframe_state)
from .topology import (Topology, cube, from_links, fully_connected,
                       hourglass, line, mesh2d, random_regular, ring, star,
                       torus3d)
