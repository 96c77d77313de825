"""Proposal movers (accelerator-native equivalents of ``MCMCpp/Movers/``)."""

from mcmcpp_tpu.movers.base import Mover
from mcmcpp_tpu.movers.stretch import StretchMove
from mcmcpp_tpu.movers.walk import WalkMove
from mcmcpp_tpu.movers.de import DifferentialEvolutionMove
from mcmcpp_tpu.movers.snooker import DESnookerMove
from mcmcpp_tpu.movers.mh import MetropolisHastingsMove
from mcmcpp_tpu.movers.dram import DRAMMove
from mcmcpp_tpu.movers.diagnostic import AutoRegressiveMove, SequenceMove
from mcmcpp_tpu.movers.mixture import MixtureMover
from mcmcpp_tpu.movers.slice import EnsembleSliceMove

__all__ = [
    "Mover",
    "StretchMove",
    "WalkMove",
    "DifferentialEvolutionMove",
    "DESnookerMove",
    "MetropolisHastingsMove",
    "DRAMMove",
    "MixtureMover",
    "EnsembleSliceMove",
    "AutoRegressiveMove",
    "SequenceMove",
]
