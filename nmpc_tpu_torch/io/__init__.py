"""Host I/O: the native runtime's bus, UDP and rate keeper, and the robots'
driver loop."""
from nmpc_tpu_torch.io.bridge import (Bus, Rate, UdpPublisher, UdpSubscriber,  # noqa: F401
                                      ensure_built, free_udp_port)
from nmpc_tpu_torch.io.robot import RobotBridge, run_realtime  # noqa: F401
