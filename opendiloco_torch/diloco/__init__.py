"""The DiLoCo outer loop: backend interface, loopback world, the TCP
galaxy (``tcp``, ``bulk``, ``rendezvous``, ``wire``), outer SGD, the
device-resident outer plane, streaming fragments, error feedback and the
optimizer that drives one worker."""
from opendiloco_torch.diloco.backend import AllReduceError, OuterBackend, PeerProgress
from opendiloco_torch.diloco.loopback import LoopbackBackend, LoopbackWorld
from opendiloco_torch.diloco.optimizer import DiLoCoOptimizer, PeerDropError
from opendiloco_torch.diloco.outer_optimizer import OuterSGD

__all__ = [
    "AllReduceError",
    "OuterBackend",
    "PeerProgress",
    "LoopbackBackend",
    "LoopbackWorld",
    "DiLoCoOptimizer",
    "PeerDropError",
    "OuterSGD",
]
