"""agp_tpu: augmented Gaussian-process inference engine.

A from-scratch JAX/XLA re-design of the capabilities of
AugmentedGaussianProcesses.jl (reference mounted at /root/reference):
sparse/full variational GPs over non-conjugate likelihoods made
conditionally conjugate by Polya-Gamma / inverse-Gamma / GIG data
augmentation, trained with closed-form natural-gradient CAVI, numerical VI,
and augmented Gibbs sampling, with ELBO-gradient hyperparameter autotuning
-- everything expressed as jitted, shardable, static-shape programs.
"""

from . import kernels
from .inference.config import (
    Analytic,
    AnalyticSVI,
    AnalyticVI,
    GibbsSampling,
    HMCSampling,
    MCIntegrationSVI,
    MCIntegrationVI,
    NumericalSVI,
    NumericalVI,
    QuadratureSVI,
    QuadratureVI,
)
from .kernels import (
    ARDTransform,
    ChainTransform,
    ConstantKernel,
    CosineKernel,
    ExponentiatedKernel,
    FBMKernel,
    FunctionTransform,
    GaborKernel,
    LinearKernel,
    LinearTransform,
    Matern12Kernel,
    Matern32Kernel,
    Matern52Kernel,
    NeuralNetworkKernel,
    PeriodicKernel,
    PiecewisePolynomialKernel,
    PolynomialKernel,
    RationalQuadraticKernel,
    RBFKernel,
    ScaleTransform,
    SelectTransform,
    SqExponentialKernel,
    TransformedKernel,
    WhiteKernel,
    with_transform,
)
from .likelihoods.base import Likelihood
from .likelihoods.classification import BayesianSVM, LogisticLikelihood
from .likelihoods.event import NegBinomialLikelihood, PoissonLikelihood
from .likelihoods.heteroscedastic import HeteroscedasticLikelihood
from .likelihoods.multiclass import (
    LogisticSoftMaxLikelihood,
    MultiClassLikelihood,
    SoftMaxLikelihood,
)
from .likelihoods.regression import (
    GaussianLikelihood,
    LaplaceLikelihood,
    Matern32Likelihood,
    StudentTLikelihood,
)
from .inference.hmc import sample_hmc, sample_nuts
from .inference.smc import smc_sample
from .inference.svgd import svgd_sample
from .likelihoods.generic import make_augmented_likelihood
from .means import AffineMean, ConstantMean, EmpiricalMean, ZeroMean
from .models.gp import GP
from .models.mcgp import MCGP, sample
from .models.multioutput import (
    MOSVGP,
    MOVGP,
    mo_elbo,
    mo_init_state,
    mo_predict_f,
    mo_predict_y,
    mo_proba_y,
    mo_train,
)
from .models.online_svgp import (
    OnlineSVGP,
    online_elbo,
    online_train,
    online_train_stream,
)
from .models.svgp import SVGP, VGP
from .models.vstp import VStP
from .training import checkpoint
from .training.ar_predict import predict_ar, sample_ar
from .training.predictions import predict_f, predict_y, proba_y, sample_f
from .training.train import elbo, init_state, train
from .utils.opt import alrsvi, robbins_monro

# reference-familiar aliases (src/AugmentedGaussianProcesses.jl exports)
ELBO = elbo

__version__ = "0.1.0"

__all__ = [
    # models (reference export list, src/AugmentedGaussianProcesses.jl:10)
    "GP",
    "VGP",
    "SVGP",
    "MCGP",
    "VStP",
    "MOVGP",
    "MOSVGP",
    "OnlineSVGP",
    # training / prediction
    "train",
    "elbo",
    "init_state",
    "predict_f",
    "predict_y",
    "proba_y",
    "sample_f",
    "predict_ar",
    "sample_ar",
    "mo_train",
    "mo_init_state",
    "mo_elbo",
    "mo_predict_f",
    "mo_predict_y",
    "mo_proba_y",
    "online_train",
    "online_train_stream",
    "online_train_stream",
    "online_elbo",
    "checkpoint",
    # inference configs
    "Analytic",
    "AnalyticVI",
    "AnalyticSVI",
    "NumericalVI",
    "NumericalSVI",
    "QuadratureVI",
    "QuadratureSVI",
    "MCIntegrationVI",
    "MCIntegrationSVI",
    "GibbsSampling",
    "HMCSampling",
    # sampling entry points
    "sample",
    "sample_hmc",
    "sample_nuts",
    "smc_sample",
    "svgd_sample",
    # likelihoods
    "Likelihood",
    "GaussianLikelihood",
    "StudentTLikelihood",
    "LaplaceLikelihood",
    "Matern32Likelihood",
    "HeteroscedasticLikelihood",
    "LogisticLikelihood",
    "BayesianSVM",
    "PoissonLikelihood",
    "NegBinomialLikelihood",
    "MultiClassLikelihood",
    "LogisticSoftMaxLikelihood",
    "SoftMaxLikelihood",
    "make_augmented_likelihood",
    # kernels
    "kernels",
    "SqExponentialKernel",
    "RBFKernel",
    "Matern12Kernel",
    "Matern32Kernel",
    "Matern52Kernel",
    "RationalQuadraticKernel",
    "CosineKernel",
    "PeriodicKernel",
    "LinearKernel",
    "PolynomialKernel",
    "ConstantKernel",
    "WhiteKernel",
    "ExponentiatedKernel",
    "PiecewisePolynomialKernel",
    "FBMKernel",
    "GaborKernel",
    "NeuralNetworkKernel",
    # input transforms
    "TransformedKernel",
    "with_transform",
    "ScaleTransform",
    "ARDTransform",
    "LinearTransform",
    "SelectTransform",
    "FunctionTransform",
    "ChainTransform",
    # prior means
    "ZeroMean",
    "ConstantMean",
    "EmpiricalMean",
    "AffineMean",
    # optimiser schedules
    "robbins_monro",
    "alrsvi",
    # aliases
    "ELBO",
]
