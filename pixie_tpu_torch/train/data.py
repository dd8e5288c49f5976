"""Material voxel dataset: scans render_outputs/{obj_id}/ directories.

Numpy port of MaterialVoxelDataset (data_utils/my_data.py:19-261): same
file contract (clip_features_features.npy, clip_features_mask.npy,
sample_{k}/material_grid.npy), same validation (material-id range check,
shape check, problematic-object blacklist, mask-consistency assert), same
normalization (log10 + p1/p99 min-max; norm.py), same deterministic
0.9/0.1 split with seed 42.

Host numpy, copied from pixie_tpu/train/data.py: items, batches, split and
split JSON are bit-identical to it.  One addition: ``item`` / ``batches``
take ``feature_dtype``, and ``None`` leaves the features as stored (float16
CLIP grids), so that the trainer copies half the bytes to the card and
casts them there, to the same float32 values.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from pixie_tpu_torch.utils.norm import NormalizationRanges, normalize_material_grid


@dataclass
class Sample:
    obj_id: str
    mat_path: str
    feat_path: str
    mask_path: str


class MaterialVoxelDataset:
    """Lazy-loading dataset over render_outputs/*/ directories."""

    def __init__(
        self,
        render_outputs_dir: str | Path,
        ranges: NormalizationRanges,
        grid_size: int = 64,
        feature_channels: int = 768,
        in_material_channels: int = 4,
        num_material_classes: int = 8,
        background_id: int = 7,
        feature_type: str = "clip",
        sample_id: int = 0,
        to_normalize: bool = True,
        enforce_mask_consistency: bool = True,
        problematic_objects_path: str | Path | None = None,
        target_obj_classes=None,
        obj_class_lookup=None,
    ):
        self.ranges = ranges
        self.grid_size = grid_size
        self.feature_channels = feature_channels
        self.num_material_classes = num_material_classes
        self.background_id = background_id
        self.feature_type = feature_type
        self.sample_id = sample_id
        self.to_normalize = to_normalize
        self.enforce_mask_consistency = enforce_mask_consistency

        problematic = set()
        if problematic_objects_path and Path(problematic_objects_path).exists():
            problematic = set(json.loads(Path(problematic_objects_path).read_text()))
            logging.warning("Loaded %d problematic objects to skip", len(problematic))

        self.samples: list[Sample] = []
        root = Path(render_outputs_dir)
        d = grid_size
        for obj_id in sorted(os.listdir(root)) if root.exists() else []:
            if obj_id in problematic:
                continue
            if target_obj_classes is not None and obj_class_lookup is not None:
                if obj_class_lookup(obj_id) not in target_obj_classes:
                    continue
            obj_dir = root / obj_id
            if feature_type == "clip":
                feat_fp = obj_dir / "clip_features_features.npy"
            elif feature_type == "rgb":
                feat_fp = obj_dir / "clip_features_rgb.npy"
            elif feature_type == "occupancy":
                feat_fp = obj_dir / f"sample_{sample_id}" / "mask.npy"
            else:
                raise ValueError(f"Invalid feature type: {feature_type}")
            mat_fp = obj_dir / f"sample_{sample_id}" / "material_grid.npy"
            mask_fp = obj_dir / "clip_features_mask.npy"
            if not feat_fp.exists() or not mat_fp.exists():
                continue

            # material-id sanity + shape validation (my_data.py:103-126)
            try:
                mat_ids = np.load(mat_fp, mmap_mode="r")[..., -1]
                if mat_ids.min() < 0 or mat_ids.max() >= num_material_classes:
                    logging.warning("Skipping %s: material_id out of range", obj_id)
                    continue
                mat_shape = np.load(mat_fp, mmap_mode="r").shape
                feat_shape = np.load(feat_fp, mmap_mode="r").shape
                if len(feat_shape) == 3:
                    feat_shape = (*feat_shape, 1)
            except Exception as e:  # noqa: BLE001
                logging.warning("Skipping %s: %s", obj_id, e)
                continue
            if mat_shape != (d, d, d, in_material_channels) or feat_shape != (
                d, d, d, feature_channels,
            ):
                logging.warning(
                    "Skipping %s: bad shapes mat=%s feat=%s", obj_id, mat_shape, feat_shape
                )
                continue
            self.samples.append(Sample(obj_id, str(mat_fp), str(feat_fp), str(mask_fp)))
        logging.info("[DATASET] Loaded %d data files.", len(self.samples))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int):
        """Returns (feat (D,D,D,C), cont (D,D,D,3), mat_id (D,D,D), mask (D,D,D), info)."""
        return self.item(idx)

    def item(self, idx: int, feature_dtype=np.float32):
        """``self[idx]`` with the features cast to ``feature_dtype`` (None:
        as stored)."""
        s = self.samples[idx]
        mat = np.load(s.mat_path).astype(np.float32)
        feat = np.load(s.feat_path)
        if feature_dtype is not None:
            feat = feat.astype(feature_dtype)
        if self.feature_type == "occupancy" and feat.ndim == 3:
            feat = feat[..., None]
        mask = np.load(s.mask_path).astype(np.float32)

        mat_id = mat[..., -1].astype(np.int64)
        expected_mask = (mat_id != self.background_id).astype(np.float32)
        if self.enforce_mask_consistency and not np.array_equal(mask, expected_mask):
            raise AssertionError(
                f"Mask inconsistency for {s.obj_id}: clip_features_mask.npy doesn't "
                f"match material_id-based mask"
            )

        if self.to_normalize:
            cont, mat_id = normalize_material_grid(mat, self.ranges)
        else:
            cont = mat[..., :3]
            mat_id = mat_id
        info = {
            "obj_id": s.obj_id,
            "sample_id": self.sample_id,
            "data_path": s.mat_path,
            "feature_path": s.feat_path,
            "mask_path": s.mask_path,
        }
        return feat, cont.astype(np.float32), mat_id, mask, info

    def batches(self, batch_size: int, indices=None, drop_remainder: bool = False,
                pad_to_batch: bool = False, feature_dtype=np.float32):
        """Yield batched numpy arrays (channel-last)."""
        idxs = list(range(len(self))) if indices is None else list(indices)
        for start in range(0, len(idxs), batch_size):
            chunk = idxs[start : start + batch_size]
            if drop_remainder and len(chunk) < batch_size:
                return
            items = [self.item(i, feature_dtype) for i in chunk]
            feat = np.stack([it[0] for it in items])
            cont = np.stack([it[1] for it in items])
            mat_id = np.stack([it[2] for it in items])
            mask = np.stack([it[3] for it in items])
            infos = [it[4] for it in items]
            n_valid = len(items)
            if pad_to_batch and n_valid < batch_size:
                pad = batch_size - n_valid
                feat = np.concatenate([feat, np.repeat(feat[-1:], pad, 0)])
                cont = np.concatenate([cont, np.repeat(cont[-1:], pad, 0)])
                mat_id = np.concatenate([mat_id, np.repeat(mat_id[-1:], pad, 0)])
                mask = np.concatenate([mask, np.repeat(mask[-1:], pad, 0)])
            yield feat, cont, mat_id, mask, infos, n_valid


def train_test_split(n: int, train_frac: float = 0.9, seed: int = 42):
    """Deterministic split matching torch random_split(generator=seed 42)
    in *size* and determinism (indices differ from torch's RNG but the split
    is persisted to JSON for reproducible eval, training_utils.py:228-241)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = int(train_frac * n)
    return perm[:n_train].tolist(), perm[n_train:].tolist()


def save_splits(path: str | Path, dataset: MaterialVoxelDataset, train_idx, test_idx):
    data = {
        "train_obj_ids": [dataset.samples[i].obj_id for i in train_idx],
        "test_obj_ids": [dataset.samples[i].obj_id for i in test_idx],
        "train_indices": list(map(int, train_idx)),
        "test_indices": list(map(int, test_idx)),
    }
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(data, indent=2))


def load_splits(path: str | Path) -> dict:
    return json.loads(Path(path).read_text())
