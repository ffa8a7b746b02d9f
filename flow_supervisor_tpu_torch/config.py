"""Experiment configuration: the fields of the JAX package's ``ModelCfg`` and
``TrainCfg`` (flow_supervisor_tpu/config.py) that the port's training path
reads, with the same names and defaults, as plain dataclasses. YAML
persistence, the argument parser and the fields of unported paths (the data
pipeline and its image sizes, validation, parallelism, tracing) are not
carried over."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ModelCfg:
    model_type: str = "raft-baseline"  # raft-baseline | raft-unsup | raft-semi | gma-*
    small: bool = False
    iters: int = 12
    dropout: float = 0.0
    corr_levels: int = 4
    corr_radius: int = 4
    # semi / flow supervisor
    teacher_iters: int = 12
    sup_weight: float = 1.0
    unsup_weight: float = 1.0
    lfr_weight: float = 1.0
    lfl_weight: float = 1.0
    sup_label_loss_weight: float = 1.0
    teacher_smurf_weight: float = 0.0
    lfl_loss_decay_rate: float = 0.8
    lfr_loss_type: str = "l2"  # reference default; the recipes use robust
    # the unsup branch's loss is a pixel sum (x B*H*W), as the reference's
    # Reduction.NONE L_fr makes it (ModelCfg of the JAX package)
    lfr_sum_reduction: bool = True
    use_bw: bool = True
    # unsupervised (SMURF) loss: the raft-unsup model's loss, and the teacher
    # SMURF term of raft-semi (which sets selfsup to 0)
    census_weight: float = 1.0
    smooth1_weight: float = 2.5
    smooth2_weight: float = 0.0
    selfsup_weight: float = 0.3
    occlusion: str = "wang"  # wang | brox | none
    unsup_loss_decay_rate: float = 0.8
    # precision
    compute_dtype: str = "bfloat16"  # bfloat16 | float32
    corr_dtype: str = "float32"
    lookup_backend: str = "auto"  # the port's RAFT takes plane | fused | pallas


@dataclasses.dataclass
class TrainCfg:
    stage: str = "chairs"
    lr: float = 4e-4
    lr_schedule: str = "onecycle"  # onecycle | exponential | smurf | constant
    lr_decay_steps: int = 25000
    lr_decay_rate: float = 0.5
    weight_decay: float = 1e-4
    clip_norm: float = 1.0
    num_steps: int = 100000
    freeze_bn: bool = False
    loss_type: str = "robust"
    loss_decay_rate: float = 0.8
    seed: int = 1234
    log_every: int = 100


@dataclasses.dataclass
class ExperimentConfig:
    model: ModelCfg = dataclasses.field(default_factory=ModelCfg)
    train: TrainCfg = dataclasses.field(default_factory=TrainCfg)
    ckpt_dir: str = "ckpts/run"
