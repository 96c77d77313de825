"""mcmcpp_tpu — an accelerator-native ensemble-MCMC / probabilistic-inference framework.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of jmatta1/MCMCpp
(header-only C++ affine-invariant ensemble MCMC; see /root/reference). The
walker ensemble is a single device array ``(2, W/2, P)`` (red/black halves),
stepped by pure functions under ``lax.scan``; the pthread worker pool of the
reference (MCMCpp/Threading/) is replaced by SPMD sharding over a
``jax.sharding.Mesh``, and pcg64 PRNG streams by counter-based threefry keys.

Public API (mirrors the reference's EnsembleSampler surface,
MCMCpp/EnsembleSampler.h:89-176, in idiomatic JAX form).
"""

from mcmcpp_tpu.sampler import EnsembleSampler, EnsembleState, sample_ball
from mcmcpp_tpu.chain import Chain
from mcmcpp_tpu.movers import (
    EnsembleSliceMove,
    MixtureMover,
    StretchMove,
    WalkMove,
    DifferentialEvolutionMove,
    DESnookerMove,
    MetropolisHastingsMove,
    DRAMMove,
    AutoRegressiveMove,
    SequenceMove,
)
from mcmcpp_tpu import analysis
from mcmcpp_tpu import io
from mcmcpp_tpu import models
from mcmcpp_tpu import ops
from mcmcpp_tpu import parallel
from mcmcpp_tpu.parallel import (
    ShardedEnsembleSampler,
    make_ladder_mesh,
    make_walker_mesh,
)
from mcmcpp_tpu import gradient
from mcmcpp_tpu.gradient import (
    BarkerSampler, CheesHMCSampler, HMCSampler, MALASampler, MAMSSampler,
    MCLMCSampler,
    MEADSSampler, NUTSSampler,
    SGHMCSampler, SGLDSampler,
)
from mcmcpp_tpu.smc import SMCSampler
from mcmcpp_tpu.ibis import IBISSampler
from mcmcpp_tpu.if2 import IF2Result, if2
from mcmcpp_tpu.eks import (
    EKIResult,
    EKSResult,
    ensemble_kalman_inversion,
    ensemble_kalman_sampler,
)
from mcmcpp_tpu.ukf import (
    UKFModel,
    UKFResult,
    unscented_kalman_filter,
    unscented_rts_smoother,
)
from mcmcpp_tpu.smc2 import SMC2Sampler
from mcmcpp_tpu.rbpf import (
    RaoBlackwellSSM, rao_blackwell_filter, rbpf_forecast,
    switching_model,
)
from mcmcpp_tpu.enkf import EnKFModel, ensemble_kalman_filter
from mcmcpp_tpu.nested import NestedSampler
from mcmcpp_tpu.vi import ADVI
from mcmcpp_tpu.svgd import SVGD
from mcmcpp_tpu import dsl
from mcmcpp_tpu.dsl import Model
from mcmcpp_tpu.tempering import (
    ParallelTemperingSampler,
    geometric_ladder,
    power_ladder,
)
from mcmcpp_tpu.convergence import ConvergenceReport, run_until_converged
from mcmcpp_tpu.map_laplace import find_map, laplace, laplace_sample
from mcmcpp_tpu.pathfinder import multi_pathfinder, pathfinder
from mcmcpp_tpu.elliptical import EllipticalSliceSampler
from mcmcpp_tpu.pcn import PCNSampler
from mcmcpp_tpu.gibbs import (
    BlockedGibbsSampler,
    CategoricalGibbsKernel,
    ExactGibbsKernel,
    EllipticalSliceKernel,
    GaussianInterweaveKernel,
    InterweaveKernel,
    HMCKernel,
    MALAKernel,
    RWMKernel,
)
from mcmcpp_tpu.particle import (
    ParticleGibbsKernel,
    PMMHSampler,
    StateSpaceModel,
    particle_filter,
    particle_forecast,
    particle_smoother,
)
from mcmcpp_tpu.chain_disk import DiskChain
from mcmcpp_tpu.neutra import NeuTra, RealNVP, IAF, SplineCoupling
from mcmcpp_tpu.export import (
    ibis_to_inference_dict,
    nested_to_inference_dict,
    smc2_to_inference_dict,
    to_arviz,
    to_inference_dict,
)

__version__ = "0.1.0"

__all__ = [
    "EnsembleSampler",
    "EnsembleState",
    "Chain",
    "DiskChain",
    "NeuTra",
    "RealNVP",
    "IAF",
    "SplineCoupling",
    "to_inference_dict",
    "ibis_to_inference_dict",
    "smc2_to_inference_dict",
    "nested_to_inference_dict",
    "to_arviz",
    "StretchMove",
    "EnsembleSliceMove",
    "WalkMove",
    "DifferentialEvolutionMove",
    "DESnookerMove",
    "MetropolisHastingsMove",
    "DRAMMove",
    "MixtureMover",
    "AutoRegressiveMove",
    "SequenceMove",
    "analysis",
    "io",
    "models",
    "ops",
    "parallel",
    "gradient",
    "BarkerSampler",
    "CheesHMCSampler",
    "HMCSampler",
    "MALASampler",
    "MAMSSampler",
    "MCLMCSampler",
    "MEADSSampler",
    "NUTSSampler",
    "SGHMCSampler",
    "SGLDSampler",
    "IBISSampler",
    "if2",
    "IF2Result",
    "EKIResult",
    "EKSResult",
    "ensemble_kalman_inversion",
    "ensemble_kalman_sampler",
    "UKFModel",
    "UKFResult",
    "unscented_kalman_filter",
    "unscented_rts_smoother",
    "SMCSampler",
    "NestedSampler",
    "geometric_ladder",
    "power_ladder",
    "ADVI",
    "SVGD",
    "dsl",
    "Model",
    "ParallelTemperingSampler",
    "ConvergenceReport",
    "run_until_converged",
    "find_map",
    "laplace",
    "laplace_sample",
    "pathfinder",
    "multi_pathfinder",
    "EllipticalSliceSampler",
    "PCNSampler",
    "BlockedGibbsSampler",
    "CategoricalGibbsKernel",
    "ExactGibbsKernel",
    "EllipticalSliceKernel",
    "GaussianInterweaveKernel",
    "InterweaveKernel",
    "HMCKernel",
    "MALAKernel",
    "RWMKernel",
    "SMC2Sampler",
    "StateSpaceModel",
    "RaoBlackwellSSM",
    "rao_blackwell_filter",
    "rbpf_forecast",
    "switching_model",
    "EnKFModel",
    "ensemble_kalman_filter",
    "particle_filter",
    "particle_forecast",
    "particle_smoother",
    "PMMHSampler",
    "ParticleGibbsKernel",
    "ShardedEnsembleSampler",
    "make_ladder_mesh",
    "make_walker_mesh",
    "sample_ball",
]
