"""The DiLoCo outer loop: backend interface, loopback world, outer SGD and
the optimizer that drives one worker (host placement, blocking rounds)."""
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
