"""Experiment configuration (counterpart of flow_supervisor_tpu/config.py):
the JAX package's ``ModelCfg``, ``TrainCfg`` and ``ExperimentConfig`` with
the same fields, names and defaults, the argument parser of the train CLI
(the same flags and reference aliases), and the config saved as
``args.yaml`` beside the checkpoints.

``args.yaml`` is read and written without ``yaml``: the writer emits a
subset of YAML (nested block mappings of scalars, flow lists of ints,
``null``, strings in double quotes) that ``yaml.safe_load`` reads back as
``to_dict()``, and the reader takes that subset and what ``yaml.safe_dump``
writes for these dataclasses (block lists, plain and quoted scalars). A run
directory works with either package.

Fields no code of the port reads, kept so the flags and ``args.yaml`` are
the JAX package's: ``stop_teacher_gradient``, ``teacher_smurf_loss`` and
``min_lr`` (read by no code in either package), ``scan_iters`` (a compile
option of the JAX forward; the port is eager), and ``corr_levels``,
``corr_radius`` (``training.loop.build_model`` fixes them as the JAX
package's does: 4 levels at radius 4, or at radius 3 for the small model).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
from argparse import ArgumentParser
from typing import Any, Optional

CONFIG_FILENAME = "args.yaml"


@dataclasses.dataclass
class ModelCfg:
    model_type: str = "raft-baseline"  # {raft,gma}-{baseline,unsup,semi}
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
    stop_teacher_gradient: bool = True
    # unsupervised (SMURF) loss: the raft-unsup model's loss, and the teacher
    # SMURF term of raft-semi (which sets selfsup to 0)
    census_weight: float = 1.0
    smooth1_weight: float = 2.5
    smooth2_weight: float = 0.0
    selfsup_weight: float = 0.3
    occlusion: str = "wang"  # wang | brox | none
    unsup_loss_decay_rate: float = 0.8
    teacher_smurf_loss: bool = False
    use_bw: bool = True
    # GMA
    num_heads: int = 1
    position_only: bool = False
    position_and_content: bool = False
    # precision
    compute_dtype: str = "bfloat16"  # bfloat16 | float32
    corr_dtype: str = "float32"
    lookup_backend: str = "auto"  # models/raft.py LOOKUP_BACKENDS; auto: fused on the card
    scan_iters: bool = False


@dataclasses.dataclass
class TrainCfg:
    stage: str = "chairs"
    batch_size: int = 8
    image_size: tuple[int, int] = (368, 496)
    unsup_image_size: tuple[int, int] = (368, 768)
    # the full frame of semi / unsup batches; None: the stage's native
    # floor-multiple-of-8 size (data/pipeline.py FULL_SIZE_DEFAULTS)
    full_size: Optional[tuple[int, int]] = None
    lr: float = 4e-4
    lr_schedule: str = "onecycle"  # onecycle | exponential | smurf | constant
    lr_decay_steps: int = 25000
    lr_decay_rate: float = 0.5
    min_lr: float = 1e-8
    weight_decay: float = 1e-4
    clip_norm: float = 1.0
    num_steps: int = 100000
    val_step: int = 5000
    val_max_records: int = 0  # cap records per standing-validation set (0 = all)
    # standing validation's iterations: 0 = the eval policy (32 sintel / 24
    # otherwise, evaluation.eval_iters_policy), > 0 = that many
    val_iters: int = 0
    val_warm_start: bool = False  # warm-start within scenes during validation
    val_pad_bucket: int = 64  # pad multiple of the sparse (KITTI) validation sets
    skip_validation_at_start: bool = False
    freeze_bn: bool = False
    loss_type: str = "robust"
    loss_decay_rate: float = 0.8
    seed: int = 1234
    # flow-aware rotation augmentation (off in every recipe)
    do_rotation: bool = False
    max_rotation: float = 10.0
    pretrained_ckpt: str = ""  # a checkpoint directory to start from
    data_parallel: int = -1  # -1 = all local devices; the port trains on one
    dcn_parallel: int = 1
    loader_workers: int = 4  # threads decoding and augmenting per stream (0/1: serial)
    log_every: int = 100
    # a torch.profiler trace of trace_steps steps, after two warm-up steps,
    # written into this directory; empty = off
    trace_dir: str = ""
    trace_steps: int = 3


_SIZE_FIELDS = ("image_size", "unsup_image_size", "full_size")


@dataclasses.dataclass
class ExperimentConfig:
    model: ModelCfg = dataclasses.field(default_factory=ModelCfg)
    train: TrainCfg = dataclasses.field(default_factory=TrainCfg)
    ckpt_dir: str = "ckpts/run"

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ExperimentConfig":
        model = ModelCfg(**d.get("model", {}))
        tr = dict(d.get("train", {}))
        for k in _SIZE_FIELDS:
            if tr.get(k) is not None:
                tr[k] = tuple(tr[k])
        return cls(model=model, train=TrainCfg(**tr), ckpt_dir=d.get("ckpt_dir", "ckpts/run"))

    def save_yaml(self, path: Optional[str] = None) -> str:
        path = path or os.path.join(self.ckpt_dir, CONFIG_FILENAME)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(dump_yaml(self.to_dict()))
        return path

    @classmethod
    def load_yaml(cls, path: str) -> "ExperimentConfig":
        if os.path.isdir(path):
            path = os.path.join(path, CONFIG_FILENAME)
        with open(path) as f:
            return cls.from_dict(load_yaml(f.read()))

    @classmethod
    def maybe_restore(
        cls,
        ckpt_dir: str,
        fallback: "ExperimentConfig",
        explicit: Optional[set] = None,
    ) -> "ExperimentConfig":
        """The config saved beside the checkpoints if there is one, with the
        fields named in ``explicit`` (the flags of this command line) taken
        from ``fallback``, so that resuming with a larger --num_steps extends
        the run; else ``fallback``, saved there."""
        path = os.path.join(ckpt_dir, CONFIG_FILENAME)
        if os.path.exists(path):
            cfg = cls.load_yaml(path)
            cfg.ckpt_dir = ckpt_dir
            for name in explicit or ():
                for section, fb in ((cfg.model, fallback.model), (cfg.train, fallback.train)):
                    if hasattr(section, name):
                        setattr(section, name, getattr(fb, name))
            return cfg
        fallback.ckpt_dir = ckpt_dir
        fallback.save_yaml(path)
        return fallback


# ---- args.yaml without yaml ----------------------------------------------


def _yaml_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        # YAML 1.1 floats need a '.' before an exponent: 1e-08 -> 1.0e-08
        return r.replace("e", ".0e") if "e" in r and "." not in r else r
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, (list, tuple)) and all(isinstance(x, int) and not isinstance(x, bool)
                                            for x in v):
        return "[" + ", ".join(str(x) for x in v) + "]"
    raise TypeError(f"args.yaml holds scalars and lists of ints, not {v!r}")


def dump_yaml(d: dict[str, Any]) -> str:
    """YAML text of a mapping whose values are scalars, lists of ints or
    mappings of those (one level), in insertion order."""
    lines = []
    for k, v in d.items():
        if isinstance(v, dict):
            lines.append(f"{k}:")
            lines.extend(f"  {k2}: {_yaml_scalar(v2)}" for k2, v2 in v.items())
        else:
            lines.append(f"{k}: {_yaml_scalar(v)}")
    return "\n".join(lines) + "\n"


# PyYAML's implicit resolvers (YAML 1.1) for the plain scalars safe_dump writes
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _plain(s: str):
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        t = s.replace("_", "").lower()
        if t.endswith("inf"):
            return -math.inf if t.startswith("-") else math.inf
        return math.nan if t.endswith("nan") else float(t)
    return s


def _scalar(text: str):
    s = text.strip()
    if s.startswith('"'):
        return json.loads(s)
    if s.startswith("'"):
        if not s.endswith("'") or len(s) < 2:
            raise ValueError(f"args.yaml: unterminated quoted scalar {text!r}")
        return s[1:-1].replace("''", "'")
    if s.startswith("[") and s.endswith("]"):
        return [_plain(x.strip()) for x in s[1:-1].split(",") if x.strip()]
    return _plain(s)


def load_yaml(text: str) -> dict[str, Any]:
    """The mapping of ``dump_yaml``'s text, or of what ``yaml.safe_dump``
    writes for an ExperimentConfig: nested block mappings, scalars (plain,
    single or double quoted, continued on more-indented lines), flow lists
    and block lists ("- item" at the key's indentation or deeper)."""
    root: dict[str, Any] = {}
    stack = [(-1, root)]  # (indentation of the keys, mapping)
    last = None  # (mapping, key, indentation) of the latest "key:" entry
    for n, raw in enumerate(text.splitlines(), 1):
        if not raw.strip() or raw.lstrip().startswith("#"):
            continue
        indent = len(raw) - len(raw.lstrip(" "))
        line = raw.strip()
        if line.startswith("- ") or line == "-":
            if last is None or indent < last[2]:
                raise ValueError(f"args.yaml line {n}: a list item outside a key: {raw!r}")
            mapping, key, _ = last
            if not isinstance(mapping[key], list):
                mapping[key] = []
            mapping[key].append(_scalar(line[1:]))
            continue
        m = re.match(r"^([A-Za-z_][A-Za-z0-9_]*):(?:\s+(.*))?$", line)
        if m is None:
            if last is not None and indent > last[2] and isinstance(last[0][last[1]], str):
                mapping, key, _ = last  # a long scalar folded onto the next line
                mapping[key] = f"{mapping[key]} {_scalar(line)}"
                continue
            raise ValueError(f"args.yaml line {n}: not a key: {raw!r}")
        while indent <= stack[-1][0]:
            stack.pop()
        mapping = stack[-1][1]
        key, value = m.group(1), m.group(2)
        if value is None or value == "":
            mapping[key] = {}
            stack.append((indent, mapping[key]))
        else:
            mapping[key] = _scalar(value)
        last = (mapping, key, indent)
    return root


# ---- command line ----------------------------------------------------------


def _add_dataclass_args(parser: ArgumentParser, dc, prefix: str = "") -> None:
    for f in dataclasses.fields(dc):
        name = f"--{prefix}{f.name}"
        default = getattr(dc, f.name)
        if isinstance(default, bool):
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=default)
        elif isinstance(default, tuple):
            parser.add_argument(name, type=int, nargs=len(default), default=list(default))
        elif default is None:
            # optional (h, w) pair (full_size): None = per-stage auto
            parser.add_argument(name, type=int, nargs=2, default=None)
        else:
            parser.add_argument(name, type=type(default), default=default)


# reference flag spellings -> field names
FLAG_ALIASES = {
    "--max_step": "num_steps",
    "--learning_rate": "lr",
    "--sup_image_size": "image_size",
    "--main_loss": "loss_type",
    "--smurf_occlusion": "occlusion",
    "--ckpt_path": "ckpt_dir",
}


def build_argparser(cfg: Optional[ExperimentConfig] = None) -> ArgumentParser:
    cfg = cfg or ExperimentConfig()
    p = ArgumentParser("flow_supervisor_tpu_torch")
    p.add_argument("ckpt_dir", nargs="?", default=cfg.ckpt_dir)
    _add_dataclass_args(p, cfg.model)
    _add_dataclass_args(p, cfg.train)
    for alias, dest in FLAG_ALIASES.items():
        if dest == "ckpt_dir":
            continue
        default = getattr(cfg.train, dest, getattr(cfg.model, dest, None))
        if dest == "image_size":
            p.add_argument(alias, dest=dest + "_alias", type=int, nargs=2, default=None)
        elif isinstance(default, float):
            p.add_argument(alias, dest=dest + "_alias", type=float, default=None)
        elif isinstance(default, int):
            p.add_argument(alias, dest=dest + "_alias", type=int, default=None)
        else:
            p.add_argument(alias, dest=dest + "_alias", type=str, default=None)
    return p


def explicit_cli_fields(argv) -> set:
    """Field names passed on the command line (through the aliases)."""
    names = set()
    for tok in argv:
        if tok.startswith("--"):
            name = tok[2:].split("=")[0]
            names.add(FLAG_ALIASES.get("--" + name, name))
    return names


def config_from_args(args) -> ExperimentConfig:
    d = dict(vars(args))
    for dest in set(FLAG_ALIASES.values()):
        v = d.pop(dest + "_alias", None)
        if v is not None:
            d[dest] = v
    model = {f.name: d[f.name] for f in dataclasses.fields(ModelCfg) if f.name in d}
    train = {f.name: d[f.name] for f in dataclasses.fields(TrainCfg) if f.name in d}
    for k in _SIZE_FIELDS:
        if isinstance(train.get(k), list):
            train[k] = tuple(train[k])
    return ExperimentConfig(
        model=ModelCfg(**model), train=TrainCfg(**train), ckpt_dir=d["ckpt_dir"]
    )
