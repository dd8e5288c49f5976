"""Material-property normalization.

Implements the exact normalization contract of the reference:
  * dataset side:  log10(density+1e-6), log10(E+1e-6), nu — each min-max
    scaled (after clipping) to [-1, 1] using p1/p99 ranges
    (reference: third_party/Wavelet-Generation/data_utils/my_data.py:135-138,
     _scale at my_data.py:137).
  * prediction side: clip to [-1,1], invert min-max, 10** for density/E
    (reference: pixie/voxel/map_pred_to_coords.py:41-75, unscale_prediction).

Ranges are loaded from ``normalization_ranges.yaml``
(reference: pixie/training_utils.py:21-47, normalization_stats/normalization_ranges.yaml).

Carried over from pixie_tpu/utils/norm.py (host numpy); ``unscale_prediction``
is the span ``material.unscale`` of ``utils.observability``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from pixie_tpu_torch.utils import observability as obs

# Number of continuous channels: density, E, nu
CONT_CH = 3


@dataclasses.dataclass(frozen=True)
class NormalizationRanges:
    """p1/p99 ranges of log10(density), log10(E) and raw nu over the dataset."""

    density_min: float
    density_max: float
    E_min: float
    E_max: float
    nu_min: float
    nu_max: float

    @classmethod
    def from_dict(cls, d: dict) -> "NormalizationRanges":
        # Prefer the p1/p99 keys, as the reference does
        # (pixie/training_utils.py:35-41).
        return cls(
            density_min=float(d.get("density_p1", d.get("density_min"))),
            density_max=float(d.get("density_p99", d.get("density_max"))),
            E_min=float(d.get("E_p1", d.get("E_min"))),
            E_max=float(d.get("E_p99", d.get("E_max"))),
            nu_min=float(d.get("nu_p1", d.get("nu_min"))),
            nu_max=float(d.get("nu_p99", d.get("nu_max"))),
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# The ranges shipped with the reference checkpoints
# (normalization_stats/normalization_ranges.yaml).
REFERENCE_RANGES = NormalizationRanges(
    density_min=1.7031893730163574,
    density_max=3.871432304382324,
    E_min=3.0183002948760986,
    E_max=10.881680488586426,
    nu_min=0.21027633547782898,
    nu_max=0.4492689371109009,
)


def load_normalization_ranges(path: str | Path) -> NormalizationRanges:
    """Load ranges from a normalization_ranges.yaml/json file.

    The reference writes the yaml file as a JSON-compatible single dict, so we
    parse with yaml if available and fall back to json.
    """
    path = Path(path)
    text = path.read_text()
    try:
        import yaml  # noqa: PLC0415

        data = yaml.safe_load(text)
    except Exception:
        data = json.loads(text)
    return NormalizationRanges.from_dict(data)


def scale_to_unit(x: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Min-max scale to [-1, 1] after clipping (my_data.py:137 ``_scale``)."""
    x = np.clip(x, lo, hi)
    return 2.0 * (x - lo) / (hi - lo) - 1.0


def normalize_material_grid(
    mat: np.ndarray, ranges: NormalizationRanges
) -> tuple[np.ndarray, np.ndarray]:
    """Normalize a raw material grid (..., 4) -> (cont (...,3) in [-1,1], mat_id (...)).

    Mirrors MaterialVoxelDataset.__getitem__ (my_data.py:160-224):
    density/E are log10(x + 1e-6) then min-max scaled; nu scaled directly.
    """
    density = np.log10(mat[..., 0] + 1e-6)
    E = np.log10(mat[..., 1] + 1e-6)
    nu = mat[..., 2]
    cont = np.stack(
        [
            scale_to_unit(density, ranges.density_min, ranges.density_max),
            scale_to_unit(E, ranges.E_min, ranges.E_max),
            scale_to_unit(nu, ranges.nu_min, ranges.nu_max),
        ],
        axis=-1,
    ).astype(np.float32)
    mat_id = mat[..., -1].astype(np.int64)
    return cont, mat_id


def unscale_prediction(pred: np.ndarray, ranges: NormalizationRanges) -> np.ndarray:
    """Convert normalized network output back to physical ranges.

    ``pred`` is (C, D, H, W) with C = 3 continuous + K categorical; the layout
    is preserved and only the first 3 channels are converted
    (map_pred_to_coords.py:41-75).
    """
    with obs.span("material.unscale"):
        cont = np.clip(pred[:CONT_CH], -1.0, 1.0)
        out = pred.copy().astype(np.float32)

        dens_log = ((cont[0] + 1.0) * (ranges.density_max - ranges.density_min) / 2.0
                    + ranges.density_min)
        out[0] = 10.0 ** dens_log

        e_log = (cont[1] + 1.0) * (ranges.E_max - ranges.E_min) / 2.0 + ranges.E_min
        out[1] = 10.0 ** e_log

        out[2] = (cont[2] + 1.0) * (ranges.nu_max - ranges.nu_min) / 2.0 + ranges.nu_min
        return out
