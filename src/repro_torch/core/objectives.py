"""SecureObjective: the model-specific slice of the COPML pipeline.

The protocol (quantize -> LCC-encode -> polynomial gradient -> secure
truncated update, core/protocol.py) is model-agnostic: every phase
operates on field arrays whose trailing dims are the model's.  What is
actually specific to "binary logistic regression" is exactly four things:

  1. the degree-r polynomial ghat whose quantized coefficients enter the
     coded-gradient kernel (Eq. 5: the sigmoid's least-squares fit),
  2. how the training targets embed into the field (y at scale 2^lg so
     ghat(Xw) - y is a single share-level subtraction),
  3. the model's shape -- a (d,) vector, or a (d, C) matrix whose C
     columns are trained simultaneously on one dataset encoding,
  4. the float reference used for update constants and accuracy scoring.

A SecureObjective bundles those four.  Three implementations:

  BinaryLogistic       the paper's objective; bit-exact to the pre-split
                       protocol (same coefficient quantization, same
                       (d,)-shaped randomness draws).
  LinearRegression     ghat(z) = z exactly (degree 1, zero coefficient
                       rounding error): gradient X^T(Xw - y).  Requires
                       cfg.r == 1, the lowest recovery threshold
                       3(K+T-1)+1.
  MulticlassLogistic   C one-vs-rest logistic columns as ONE (d, C) field
                       matrix: the dataset is quantized/shared/LCC-encoded
                       once and every phase carries a trailing class axis,
                       so the hot loop is a field matmul X~^T ghat(X~ W)
                       instead of C matvec dispatches, and the per-client
                       exchange grows only by the model width (the
                       CodedPrivateML encode-once/compute-many structure).

Objectives are frozen dataclasses (hashable -- api.Workload caches
protocol drivers per workload) and registered by name (`logistic`,
`linreg`, `ovr10`) for the docs lint and the CLI.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import field, sigmoid_approx
from .labels import Public


@dataclasses.dataclass(frozen=True)
class SecureObjective:
    """Base class: quantized polynomial gradient spec + float reference.

    Subclasses override the class attributes / methods below; everything
    the protocol layers consume is expressed through this interface, so a
    new model family plugs into copml / mpc_baseline / float / poly_float
    / secure_agg without touching the phase code.
    """

    name = "?"
    dataset_kind = "binary"       # data/pipeline builder: binary |
    #                               multiclass | regression
    n_outputs = 1                 # C: model columns (1 = vector model)

    # ------------------------------------------------------------- shapes

    @property
    def out_shape(self) -> tuple:
        """Trailing model/target dims: () for a vector model, (C,) for a
        class-batched matrix model."""
        return () if self.n_outputs == 1 else (self.n_outputs,)

    def w_shape(self, d: int) -> tuple:
        return (d,) + self.out_shape

    # ---------------------------------------------- polynomial gradient

    def validate_cfg(self, cfg) -> None:
        """Raise ValueError if cfg's polynomial degree cannot express this
        objective's gradient."""
        if cfg.r < 1:
            raise ValueError(f"objective {self.name!r} needs degree r >= 1")

    def float_coeffs(self, r: int, bound: float) -> tuple:
        """ghat's float coefficients c_0..c_r, lowest degree first."""
        raise NotImplementedError

    def field_coeffs(self, cfg) -> Public:
        """Field-embedded ghat coefficients on the protocol's scale ladder:
        degree-i coefficient quantized at 2^(lg - i*lz) so ghat of an
        lz-scaled argument comes out at scale lg (App. A)."""
        self.validate_cfg(cfg)
        scales = [cfg.lg - i * cfg.lz for i in range(cfg.r + 1)]
        out = []
        for c, s in zip(self.float_coeffs(cfg.r, cfg.sigmoid_bound), scales):
            assert s >= 0, "negative coefficient scale; increase cb"
            out.append(int(round(float(c) * (1 << s))) % field.P)
        return np.asarray(out, dtype=np.int32)

    def update_constants(self, cfg, m: int) -> tuple:
        """(q_eta, e, k1, k2) for the secure truncated update.  All three
        objectives share the eta/m scaling (each model column sees the
        full-batch gradient of its own scalar problem)."""
        from .protocol import derive_update_constants
        return derive_update_constants(cfg, m)

    # ------------------------------------------------------------ targets

    def prepare_targets(self, y) -> np.ndarray:
        """Float target tensor quantized at 2^lg by the protocols: shape
        (m,) + out_shape.  `y` is the dataset's label array."""
        return np.asarray(y, np.float32)

    # ----------------------------------------------------- float reference

    def act_np(self, z):
        """The exact activation ghat approximates (numpy, float64)."""
        raise NotImplementedError

    def act_torch(self, z):
        """The same activation on a torch tensor (the float trainers and
        secure_agg's client gradients, on the run's device)."""
        raise NotImplementedError

    def score(self, w, x, y) -> float:
        """Scalar quality of model `w` on (x, y): classification accuracy
        for the logistic objectives, R^2 for regression."""
        raise NotImplementedError

    def per_class_accuracy(self, w, x, y):
        """(C,) per-class accuracy for matrix models, None otherwise."""
        return None


@dataclasses.dataclass(frozen=True)
class BinaryLogistic(SecureObjective):
    """The paper's objective: binary logreg with the degree-r sigmoid fit."""

    name = "logistic"

    def float_coeffs(self, r: int, bound: float) -> tuple:
        return sigmoid_approx.fit_sigmoid_poly(r, bound)

    def act_np(self, z):
        return 1.0 / (1.0 + np.exp(-z))

    def act_torch(self, z):
        return torch.sigmoid(z)

    def score(self, w, x, y) -> float:
        z = np.asarray(x, np.float64) @ np.asarray(w, np.float64)
        return float(((self.act_np(z) > 0.5) == np.asarray(y)).mean())


@dataclasses.dataclass(frozen=True)
class LinearRegression(SecureObjective):
    """Linear regression: ghat(z) = z exactly, gradient X^T(Xw - y).

    Degree 1 with zero coefficient rounding error (the field coefficient
    of z is exactly 2^cb), hence the lowest recovery threshold the
    protocol admits: R = 3(K+T-1)+1.
    """

    name = "linreg"
    dataset_kind = "regression"

    def validate_cfg(self, cfg) -> None:
        if cfg.r != 1:
            raise ValueError(
                f"linreg's gradient polynomial is exactly degree 1; "
                f"set cfg.r = 1 (got r={cfg.r})")

    def float_coeffs(self, r: int, bound: float) -> tuple:
        return (0.0, 1.0)

    def act_np(self, z):
        return z

    def act_torch(self, z):
        return z

    def score(self, w, x, y) -> float:
        """R^2 on (x, y) (1 = perfect fit; can go negative early)."""
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        resid = x @ np.asarray(w, np.float64) - y
        denom = float(((y - y.mean()) ** 2).sum()) or 1.0
        return float(1.0 - (resid ** 2).sum() / denom)


@dataclasses.dataclass(frozen=True)
class MulticlassLogistic(SecureObjective):
    """C one-vs-rest logistic regressions as one (d, C) field matrix.

    Targets are the one-hot embedding of integer class labels (each column
    is a binary problem over the SAME rows); prediction is the argmax over
    the C column scores (sigmoid is monotone, so the raw logits argmax is
    the one-vs-rest decision)."""

    n_classes: int = 10

    dataset_kind = "multiclass"

    def __post_init__(self):
        if self.n_classes < 2:
            raise ValueError("multiclass needs n_classes >= 2")

    @property
    def name(self) -> str:
        return f"ovr{self.n_classes}"

    @property
    def n_outputs(self) -> int:
        return self.n_classes

    def float_coeffs(self, r: int, bound: float) -> tuple:
        return sigmoid_approx.fit_sigmoid_poly(r, bound)

    def prepare_targets(self, y) -> np.ndarray:
        labels = np.asarray(y)
        if labels.ndim != 1:
            raise ValueError(f"expected (m,) class labels, got {labels.shape}")
        idx = labels.astype(np.int64)
        if idx.min(initial=0) < 0 or idx.max(initial=0) >= self.n_classes:
            raise ValueError(
                f"class labels must be in [0, {self.n_classes}); got range "
                f"[{idx.min()}, {idx.max()}]")
        return np.eye(self.n_classes, dtype=np.float32)[idx]

    def act_np(self, z):
        return 1.0 / (1.0 + np.exp(-z))

    def act_torch(self, z):
        return torch.sigmoid(z)

    def predict(self, w, x) -> np.ndarray:
        scores = np.asarray(x, np.float64) @ np.asarray(w, np.float64)
        return np.argmax(scores, axis=1)

    def score(self, w, x, y) -> float:
        return float((self.predict(w, x) == np.asarray(y)).mean())

    def per_class_accuracy(self, w, x, y) -> np.ndarray:
        """(C,) per-class recall of the argmax prediction (NaN for classes
        absent from the eval set)."""
        pred = self.predict(w, x)
        labels = np.asarray(y)
        out = np.full(self.n_classes, np.nan)
        for c in range(self.n_classes):
            mask = labels == c
            if mask.any():
                out[c] = float((pred[mask] == c).mean())
        return out


# ------------------------------------------------------------------ registry

OBJECTIVES: dict = {}


def register(obj: SecureObjective, replace: bool = False) -> SecureObjective:
    if not replace and obj.name in OBJECTIVES:
        raise ValueError(f"objective {obj.name!r} already registered")
    OBJECTIVES[obj.name] = obj
    return obj


def get(name: str) -> SecureObjective:
    if name not in OBJECTIVES:
        known = ", ".join(sorted(OBJECTIVES))
        raise KeyError(f"unknown objective {name!r}; registered: {known}")
    return OBJECTIVES[name]


def names() -> tuple:
    return tuple(sorted(OBJECTIVES))


def multiclass_logistic(n_classes: int) -> MulticlassLogistic:
    """An ad-hoc C-class one-vs-rest objective (need not be registered)."""
    return MulticlassLogistic(n_classes=n_classes)


BINARY_LOGISTIC = register(BinaryLogistic())
LINREG = register(LinearRegression())
OVR10 = register(multiclass_logistic(10))
