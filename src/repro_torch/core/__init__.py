"""bittide core on PyTorch (port of ``repro.core``).

  topology     network graphs (numpy copy of the reference's builders)
  controller   proportional / discrete FINC-FDEC / PI control on tensors
  frame_model  the abstract frame model: the segment-sum lane
               (``simulate`` / ``simulate_ensemble``)
  envelopes    closed-form occupancy step-response envelopes and the
               reframing guard margins (numpy copy)
  reframing    frame rotation: RTT-conserving pointer shifts (numpy copy)
  ddc          bit-faithful domain difference counters (int64 words)
  latency      logical latency / RTT extraction (numpy copy)
  frame_level  frame-accurate discrete-event oracle (numpy copy)
  schedule     AOT collective/pipeline timetables (pure-Python copy)
  network      BittideNetwork facade: sync() -> LogicalSynchronyNetwork,
               run_scenario() on any engine
"""
from . import (controller, ddc, envelopes, frame_level, frame_model, latency,
               network, reframing, schedule, topology)
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
from .network import BittideNetwork, OscillatorSpec, SyncOutcome
from .schedule import (LogicalSynchronyNetwork, pipeline_schedule,
                       ring_allreduce_schedule, verify_bounded)
