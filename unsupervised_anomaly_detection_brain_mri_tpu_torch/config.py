"""Configuration system.

Re-designs the reference's three-level config surface
(`config.default.json`,
`utils/default_config_setup.py:21-271`, and the per-trainer
nested ``Config`` classes, e.g. `trainers/DLMODEL.py:13-26`,
`trainers/AEMODEL.py:13-23`) as a single typed dataclass tree.

The reference scattered hyperparameters across JSON path globals, an options
dict, and mutable Config objects copied field-by-field
(`utils/default_config_setup.py:245-271`).  Here there is ONE ``Config``
dataclass whose field names keep parity with the reference (``batchsize``,
``learningrate``, ``zDim``, ``intermediateResolutions`` ...), plus an
``Options`` dataclass holding the data/eval pipeline knobs that the reference
kept in the options dict (`utils/default_config_setup.py:21-57`).

Copy of `unsupervised_anomaly_detection_brain_mri_tpu/config.py`
for the port, whole and unchanged: the names, defaults and ``config.json``
format are the JAX package's, so workdirs interchange.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple


class Dataset(str, enum.Enum):
    """Mirrors the reference `utils/default_config_setup.py:13-18`."""

    BRAINWEB = "Brainweb"
    MSLUB = "MSLUB"
    MSISBI2015 = "MSISBI2015"
    MSSEG2008 = "MSSEG2008"
    SYNTH = "Synth"  # new: procedural phantom dataset for tests/benchmarks


class Optimizer(str, enum.Enum):
    """Mirrors `trainers/DLMODEL.py:112-131` optimizer types."""

    ADAM = "ADAM"
    SGD = "SGD"
    MOMENTUM = "MOMENTUM"
    RMSPROP = "RMS"


@dataclass
class PathConfig:
    """Path roots — parity with `config.default.json:1-9`."""

    brainweb_dir: str = "data/brainweb"
    mslub_dir: str = "data/mslub"
    msisbi2015_dir: str = "data/msisbi2015"
    msseg2008_dir: str = "data/msseg2008"
    checkpoint_dir: str = "checkpoints"
    sample_dir: str = "samples"
    log_dir: str = "logs"

    @classmethod
    def from_json(cls, path: str) -> "PathConfig":
        with open(path) as f:
            raw = json.load(f)
        mapping = {
            "BRAINWEBDIR": "brainweb_dir",
            "MSLUBDIR": "mslub_dir",
            "MSISBI2015DIR": "msisbi2015_dir",
            "MSSEG2008DIR": "msseg2008_dir",
            "CHECKPOINTDIR": "checkpoint_dir",
            "SAMPLEDIR": "sample_dir",
            "LOGDIR": "log_dir",
        }
        kwargs = {mapping[k]: v for k, v in raw.items() if k in mapping}
        return cls(**kwargs)


@dataclass
class MeshConfig:
    """Device-mesh layout for SPMD execution.

    The reference was single-device (`run.py:50`); here parallelism is a
    first-class config knob.  ``data`` shards the batch, ``model`` shards
    parameters (tensor parallelism; defaults to 1 for these small convnets).
    ``None`` for data means "all remaining devices".
    """

    data: Optional[int] = None
    model: int = 1


@dataclass
class Config:
    """Model/training hyperparameters.

    Field-name parity with the reference trainer Config hierarchy
    (`trainers/DLMODEL.py:13-26` -> `trainers/AEMODEL.py:13-23` -> per-trainer
    extras, see SURVEY.md section 2.2/2.7).
    """

    # identity
    trainer: str = "AE"
    model: str = "autoencoder"
    description: str = "exp"

    # core training (DLMODEL.Config / AEMODEL.Config parity)
    batchsize: int = 8
    learningrate: float = 1e-4
    numEpochs: int = 1
    optimizer: Optimizer = Optimizer.ADAM
    beta1: float = 0.5
    beta2: float = 0.999
    weightRegularization: float = 0.0
    l1_weight: float = 1.0

    # architecture (AEMODEL.Config parity)
    outputWidth: int = 128
    outputHeight: int = 128
    numChannels: int = 1
    zDim: int = 128
    intermediateResolutions: Tuple[int, int] = (8, 8)
    dropout_rate: float = 0.2

    # precision policy — TPU-native addition: bf16 compute, f32 params
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # opt-in NON-PARITY perf: space-to-depth(2x2)+Conv(3x3) input stem on
    # the unified encoder instead of Conv(5x5, s=2) on the C=1 input (the
    # parity stem contracts 25 values/output on a 128-lane MXU).  Changes
    # the architecture — off by default; see models/layers.py.
    spaceToDepthStem: bool = False
    # opt-in NON-PARITY perf: replace the decoder's full-resolution 32-ch
    # ConvT stage + 1x1 head with Conv(3x3, 4*C_out) at half resolution +
    # depth-to-space — removes the train step's dominant HBM traffic.
    depthToSpaceHead: bool = False
    # PARITY-PRESERVING perf (default ON): decoder ConvT stages route
    # through a custom VJP whose kernel gradient avoids XLA's
    # full-feature-map spatial `reverse` (the AE step's measured pure
    # waste, ~7.6%); same forward bit-for-bit, same parameter tree,
    # shared checkpoints; gradients agree to float reassociation.
    # Measured 1.08x AE train marginal throughput on TPU v5e
    # (24.0k -> 26.0k slices/s).  `--no-fast-convt-grad` opts out.
    fastConvTGrad: bool = True

    # early stopping (AEMODEL.indicate_early_stopping parity: patience 5)
    earlyStoppingPatience: int = 5

    # checkpoint cadence / retention
    snapshotEveryEpochs: int = 1
    keepCheckpoints: int = 5

    # --- per-algorithm extras (reference per-trainer Config fields) ---
    # VAE_You / GMVAE restoration (`trainers/GMVAE.py:12-21`)
    restore_lr: float = 1e-3
    restore_steps: int = 150
    tv_lambda: float = -1.0
    # ceVAE (`trainers/ceVAE.py`)
    use_gradient_based_restoration: float = 0.0
    # GMVAE mixture dims (`trainers/GMVAE.py:12-21`)
    dim_c: int = 6
    dim_z: int = 1
    dim_w: int = 1
    c_lambda: float = 1.0
    # adversarial (`trainers/AAE.py`, `trainers/fAnoGAN.py`)
    scale: float = 10.0  # WGAN-GP gradient penalty weight
    rho: float = 1.0  # constrained-AE latent consistency weight
    kappa: float = 1.0  # fAnoGAN izif feature-matching weight
    kl_weight: float = 1.0  # AnoVAEGAN

    # parallelism (new)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # debugging — aborts on the first NaN anywhere in the jitted step
    # (fills the reference's missing sanitizer role, SURVEY.md section 5)
    debugNaN: bool = False

    # rng
    seed: int = 42

    def model_dir(self, dataset: str = "") -> str:
        """Checkpoint/sample directory naming, parity with
        `trainers/AEMODEL.py:54-61`:
        ``{trainer}_d{ds}_s{W}x{H}_{model}_b{bs}_z{z}_{desc}``.
        """
        # the s2d stem / d2s head change the parameter tree — tag the
        # directory so such a run never resumes a parity checkpoint
        stem = ("_s2d" if self.spaceToDepthStem else "") + (
            "_d2s" if self.depthToSpaceHead else "")
        return (
            f"{self.trainer}_d{dataset}_s{self.outputWidth}x{self.outputHeight}"
            f"_{self.model}{stem}_b{self.batchsize}_z{self.zDim}"
            f"_{self.description}"
        )

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        def enc(o: Any) -> Any:
            if isinstance(o, enum.Enum):
                return o.value
            if dataclasses.is_dataclass(o):
                return dataclasses.asdict(o)
            return str(o)

        return json.dumps(dataclasses.asdict(self), default=enc, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)
        if "mesh" in raw and isinstance(raw["mesh"], dict):
            raw["mesh"] = MeshConfig(**raw["mesh"])
        if "intermediateResolutions" in raw:
            raw["intermediateResolutions"] = tuple(raw["intermediateResolutions"])
        if "optimizer" in raw:
            raw["optimizer"] = Optimizer(raw["optimizer"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})


@dataclass
class Options:
    """Data/eval pipeline options — parity with the reference options dict
    (`utils/default_config_setup.py:21-57`).
    """

    paths: PathConfig = field(default_factory=PathConfig)

    # data pipeline
    train_dataset: Dataset = Dataset.BRAINWEB
    test_dataset: Dataset = Dataset.BRAINWEB
    sliceStart: int = 20
    sliceEnd: int = 130
    numRandomCropsPerSlice: int = 0
    onlyPatchesWithLesions: bool = False
    addInstanceNoise: bool = False
    axis: str = "axial"
    filterProtocol: Sequence[str] = ("FLAIR",)
    normalizationMethod: str = "scaling"  # 'scaling' | 'standardization'
    upperpercentile: float = 99.8
    lowerpercentile: Optional[float] = None
    skullStripping: bool = True
    backgroundRemoval: bool = False
    cache: bool = True
    debug: bool = False

    # partitions per dataset (reference: BRAINWEB {0.7,0.3,0.0} fractions,
    # MS sets absolute patient counts — `default_config_setup.py:87-242`)
    partition: Dict[str, float] = field(
        default_factory=lambda: {"TRAIN": 0.7, "VAL": 0.3, "TEST": 0.0}
    )

    # evaluation (`utils/default_config_setup.py:40-57`)
    threshold: Optional[float] = None  # None == 'bestdice'
    numMonteCarloSamples: int = 0
    keepOnlyPositiveResiduals: bool = True
    # reference default TRUE (`utils/default_config_setup.py:56`); the CLI
    # dispatch paths still set it explicitly per protocol step
    applyHyperIntensityPrior: bool = True
    medianFiltering: bool = True
    erodeBrainmask: bool = True
    erosionIterations: int = 12
    minLesionSize: int = 7  # CC filtering: components <= this are removed
    exportVolumes: bool = False
    exportPNGs: bool = False
    computePRC: bool = True
    computeROC: bool = True
    # Volumes stacked through ONE vmapped dispatch of the iterative
    # restoration loop (VAE_You/GMVAE eval, `trainers/VAE_You.py:125-147`).
    # Each volume keeps its exact per-volume semantics (own rng stream,
    # own restoration-batch scale); 1 restores volumes sequentially.
    restorationVolumeBatch: int = 4

    # training pool residency.  By default the whole slice pool is uploaded
    # once and lives in HBM (the fastest path at reference scale, ~100 MB).
    # When the pool exceeds streamPoolThresholdMB — or streamPool is set —
    # epochs instead scan over host-prefetched device-resident CHUNKS of
    # streamPoolChunkBatches batches each (the next chunk's upload overlaps
    # the current chunk's compute), so fit() has no HBM capacity cliff.
    # Update/rng semantics are identical to the resident pool (parity
    # tested); the reference streamed from host every batch
    # (`dataloaders/BRAINWEB.py:411-478`) and had no cliff either.
    streamPool: bool = False
    streamPoolThresholdMB: float = 4096.0
    streamPoolChunkBatches: int = 64

    # logging / profiling
    tensorboard: bool = False
    profileDir: Optional[str] = None  # jax.profiler trace of the first epoch
    # opt-in per-batch console logging from inside the jitted epoch scan
    # (async debug callback) — parity with the reference's per-batch prints
    # (`trainers/AE.py:86`); 0 keeps the epoch program callback-free
    logEveryNBatches: int = 0
    # opt-in mid-epoch TensorBoard summaries every N batches (scalars +
    # input|rec|L1 image grid), parity with the reference's
    # tfSummaryAfter=100 (`trainers/DLMODEL.py:24`, `trainers/AEMODEL.py:
    # 37-42`); requires tensorboard=True.  0 = per-epoch TB only.
    tbEveryNBatches: int = 0

    def replace(self, **kw: Any) -> "Options":
        return dataclasses.replace(self, **kw)


def default_options(**kw: Any) -> Options:
    """Factory mirroring `utils/default_config_setup.py:21-57` defaults."""
    return Options(**kw)


# Per-dataset partition defaults (`utils/default_config_setup.py:87-242`).
DATASET_PARTITIONS: Dict[Dataset, Dict[str, float]] = {
    Dataset.BRAINWEB: {"TRAIN": 0.7, "VAL": 0.3, "TEST": 0.0},
    Dataset.MSSEG2008: {"TRAIN": 0.0, "VAL": 2, "TEST": 8},
    Dataset.MSISBI2015: {"TRAIN": 0.0, "VAL": 5, "TEST": 15},
    Dataset.MSLUB: {"TRAIN": 0.0, "VAL": 5, "TEST": 25},
    Dataset.SYNTH: {"TRAIN": 0.6, "VAL": 0.2, "TEST": 0.2},
}


# Experiment matrix — parity with `mains/main_*.py` (SURVEY.md section 2.7).
EXPERIMENT_PRESETS: Dict[str, Dict[str, Any]] = {
    # main_AE is the ONLY reference main with numEpochs=2 (`mains/main_AE.py:11`)
    "AE": dict(trainer="AE", model="autoencoder", batchsize=128, learningrate=1e-4,
               numEpochs=2, intermediateResolutions=(8, 8), dropout_rate=0.2),
    "AE_spatial": dict(trainer="AE", model="autoencoder_spatial", batchsize=8,
                       learningrate=1e-4, intermediateResolutions=(8, 8), dropout_rate=0.2),
    "VAE": dict(trainer="VAE", model="variational_autoencoder", batchsize=8,
                learningrate=1e-4, intermediateResolutions=(8, 8), dropout_rate=0.1),
    "VAE_Zimmerer": dict(trainer="VAE", model="variational_autoencoder_Zimmerer",
                         batchsize=8, learningrate=1e-4, dropout_rate=0.1),
    "VAE_You": dict(trainer="VAE_You", model="variational_autoencoder", batchsize=8,
                    learningrate=1e-4, dropout_rate=0.1, restore_lr=1e-3,
                    restore_steps=150, tv_lambda=-1.0),
    "CE": dict(trainer="CE", model="autoencoder", batchsize=8, learningrate=1e-3,
               dropout_rate=0.1),
    "ceVAE": dict(trainer="ceVAE", model="context_encoder_variational_autoencoder",
                  batchsize=8, learningrate=1e-4, numEpochs=3, dropout_rate=0.1,
                  use_gradient_based_restoration=0.1),
    # the ceVAE trainer Config defaults use_gradient_based_restoration=True
    # (`trainers/ceVAE.py:16`) and main_ceVAE_Zimmerer does not override it,
    # so eval restores with lambda True == 1.0 (`trainers/ceVAE.py:139`)
    "ceVAE_Zimmerer": dict(trainer="ceVAE",
                           model="context_encoder_variational_autoencoder_Zimmerer",
                           batchsize=8, learningrate=1e-4, dropout_rate=0.1,
                           use_gradient_based_restoration=1.0),
    "GMVAE": dict(trainer="GMVAE", model="gaussian_mixture_variational_autoencoder",
                  batchsize=8, learningrate=5e-5, dropout_rate=0.1, dim_c=9,
                  dim_z=128, dim_w=1, c_lambda=1.0, restore_steps=3),
    "GMVAE_spatial": dict(trainer="GMVAE_spatial",
                          model="gaussian_mixture_variational_autoencoder_spatial",
                          batchsize=8, learningrate=5e-5, dropout_rate=0.1, dim_c=9,
                          dim_z=1, dim_w=1, restore_steps=150),
    "GMVAE_You": dict(trainer="GMVAE_spatial",
                      model="gaussian_mixture_variational_autoencoder_You",
                      batchsize=8, learningrate=5e-5, dropout_rate=0.1, dim_c=9,
                      dim_z=1, dim_w=1, restore_steps=0),
    "AAE": dict(trainer="AAE", model="adversarial_autoencoder", batchsize=128,
                learningrate=1e-4, intermediateResolutions=(16, 16),
                dropout_rate=0.1, scale=10.0),
    "constrainedAE": dict(trainer="ConstrainedAE", model="constrained_autoencoder",
                          batchsize=8, learningrate=1e-3, zDim=1024,
                          intermediateResolutions=(16, 16), dropout_rate=0.1, rho=1.0),
    "constrainedAAE": dict(trainer="ConstrainedAAE",
                           model="constrained_adversarial_autoencoder", batchsize=8,
                           learningrate=1e-3, intermediateResolutions=(16, 16),
                           dropout_rate=0.1, scale=1.0, rho=1.0),
    "constrainedAAE_Chen": dict(trainer="ConstrainedAAE",
                                model="constrained_adversarial_autoencoder_Chen",
                                batchsize=8, learningrate=1e-3,
                                intermediateResolutions=(16, 16), dropout_rate=0.1,
                                scale=10.0, rho=1.0),
    "fAnoGAN": dict(trainer="fAnoGAN", model="fanogan", batchsize=8,
                    learningrate=1e-3, intermediateResolutions=(16, 16),
                    dropout_rate=0.1, kappa=1.0, scale=10.0),
    "fAnoGAN_schlegl": dict(trainer="fAnoGAN", model="fanogan_schlegl", batchsize=8,
                            learningrate=1e-3, zDim=64,
                            intermediateResolutions=(16, 16), dropout_rate=0.1,
                            kappa=1.0, scale=10.0),
    "AnoVAEGAN": dict(trainer="AnoVAEGAN", model="anovaegan", batchsize=8,
                      learningrate=1e-4, dropout_rate=0.1),
}


def preset(name: str, **overrides: Any) -> Config:
    """Build a Config from an experiment preset (mains/ parity)."""
    if name not in EXPERIMENT_PRESETS:
        raise KeyError(f"unknown preset {name!r}; known: {sorted(EXPERIMENT_PRESETS)}")
    kw = dict(EXPERIMENT_PRESETS[name])
    kw.update(overrides)
    return Config(**kw)
