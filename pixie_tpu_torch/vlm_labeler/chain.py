"""VLM labeling chain orchestration (the material_mode=vlm path; port of
pixie_tpu/vlm_labeler/chain.py).

Reference flow (pipeline.py:482-496): vlm_seg -> viz candidates ->
seg critic -> phys sampler (one sample_i per draw) -> parse critic ->
CLIP part segmentation producing segmented_semantics.ply + material_grid.npy
(the U-Net training labels).

The stages and their fallbacks are JAX's.  What runs on ``device`` (the
card unless the caller asks for the CPU): the fine re-voxelization, the
CLIP text tower, the similarity products and the part segmentation.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

from pixie_tpu_torch.vlm_labeler.agent import AgentConfig
from pixie_tpu_torch.vlm_labeler.stages import (
    MathSamplerAgent,
    SegmentationAgent,
    SegmentationCriticAgent,
    merge_best_query,
)


def load_training_views(data_dir: str | Path, n_views: int = 15, seed: int = 0):
    """Sample rendered training views for the VLM prompts (vlm_seg.py:16-59)."""
    from PIL import Image  # noqa: PLC0415

    pngs = sorted(Path(data_dir).glob("*.png"))
    if not pngs:
        raise FileNotFoundError(f"no rendered views in {data_dir}")
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(pngs), min(n_views, len(pngs)), replace=False)
    return [Image.open(pngs[i]).convert("RGB") for i in picks]


def viz_seg_candidates(
    paths: dict,
    all_queries: list[list[str]],
    text_encoder=None,
    query_embs=None,
    grid_size: int = 200,
    gray_threshold: float = 0.05,
    softmax_temperature: float = 0.1,
    overwrite: bool = False,
    device: str | torch.device = "cuda",
):
    """Stage 2: re-voxelize the trained field at the fine viz grid (200^3,
    reference vlm_viz_seg_candidates.py:10-73) and render per-candidate CLIP
    similarity heatmaps for the critic.

    Returns {query_idx: [heatmap paths]}.  Falls back to the 64^3 learning
    voxelization when no trained field is available (offline fixtures), and
    to {} when neither exists.  A grid re-voxelized here is read from the
    device (the voxelizer's ``features_dev``, bitwise the npy it writes);
    one found on disk is read from its npy.
    """
    from pixie_tpu_torch.utils.paths import voxel_artifact_paths  # noqa: PLC0415
    from pixie_tpu_torch.voxel import segmentation  # noqa: PLC0415
    from pixie_tpu_torch.voxel.viz_segmentation import (  # noqa: PLC0415
        render_similarity_heatmaps,
    )

    render_out = Path(paths["render_output"])
    fine_npz = render_out / f"clip_features_{grid_size}.npz"
    feats = None

    if overwrite or not fine_npz.exists():
        try:
            from pixie_tpu_torch.recon.field_adapter import load_field_adapter  # noqa: PLC0415
            from pixie_tpu_torch.voxel.voxelize import extract_feature_voxel_grid  # noqa: PLC0415

            adapter = load_field_adapter(paths["nerf_output"], device=device)
            vox = extract_feature_voxel_grid(
                adapter, fine_npz, voxel_size=1.0 / grid_size,
                gray_threshold_for_mask=gray_threshold, expected_grid=None, device=device,
            )
            vox["wait"]()    # the features npy is a contract: written before we go on
            feats = vox.pop("features_dev")
        except Exception as e:  # noqa: BLE001
            logging.warning("fine re-voxelization unavailable (%s)", e)

    src = fine_npz if fine_npz.exists() else Path(
        voxel_artifact_paths(str(render_out))["npz"])
    feat_p = Path(str(src).replace(".npz", "_features.npy"))
    if not feat_p.exists():
        logging.warning("no voxel features for candidate viz; skipping")
        return {}
    if feats is None:
        feats = torch.as_tensor(np.load(feat_p))   # widened to float32 a chunk at a time
    mask_p = Path(str(src).replace(".npz", "_mask.npy"))
    if mask_p.exists():
        occ = np.load(mask_p).astype(bool)
    else:
        occ = np.ones(feats.shape[:-1], bool)
    if not occ.any():
        # a field too thin for the fine grid's alpha threshold (JAX's chain
        # fails here on an empty array)
        logging.warning("no occupied voxel in %s; skipping candidate viz", src)
        return {}
    coords = np.stack(np.nonzero(occ), axis=-1).astype(np.float32)
    coords /= max(feats.shape[0] - 1, 1)
    fo = feats[torch.as_tensor(occ, device=feats.device)]
    del feats

    base_dir = Path(paths["vlm_base_dir"])
    out = {}
    for i, queries in enumerate(all_queries):
        # precomputed embeddings only apply when aligned with this set
        qe = query_embs if query_embs is not None and \
            len(np.asarray(query_embs)) == len(queries) else None
        try:
            q_embs = segmentation.encode_queries(queries, text_encoder, qe)
        except Exception as e:  # noqa: BLE001
            logging.warning("query encoding unavailable (%s); skipping viz", e)
            return out
        _, sims = segmentation.run_clip_similarity(fo, q_embs, softmax_temperature, device)
        out[i] = render_similarity_heatmaps(
            coords, sims, queries, base_dir / f"query_{i}")
    return out


def _resolve_text_encoder(cfg, device: str | torch.device = "cuda"):
    """CLIP text encoder when weights are available; optionally a
    deterministic hash-embedding fallback (plumbing-only — similarity maps
    are meaningless) when ``segmentation.allow_hash_text_encoder`` is set,
    e.g. for offline golden-path runs.  None otherwise (stage 5 then
    requires precomputed query embeddings).  The CLIP snapshot is only ever
    read from local files (``recon.clip_features.find_snapshot``), so no
    offline switch is needed for the probe."""
    feat_dim = int(cfg.training.get("feature_channels", 768))

    try:  # load the tower once and probe it
        from pixie_tpu_torch.recon.clip_features import CLIPTextEncoder  # noqa: PLC0415

        clip_encoder = CLIPTextEncoder(device=device)
        clip_encoder(["probe"])
        return clip_encoder
    except Exception as e:  # noqa: BLE001
        if not cfg.segmentation.get("allow_hash_text_encoder", False):
            logging.warning("CLIP text encoder unavailable (%s)", e)
            return None
        logging.warning(
            "CLIP text encoder unavailable (%s); USING HASH EMBEDDINGS — "
            "segmentation similarities are placeholders", e)

        def hash_encoder(queries):
            import hashlib  # noqa: PLC0415

            embs = []
            for q in queries:
                # stable digest: Python's hash() is salted per process
                # (PYTHONHASHSEED), which would break run-to-run determinism
                rng = np.random.default_rng(int.from_bytes(
                    hashlib.sha256(str(q).encode()).digest()[:4], "little"))
                v = rng.normal(size=(feat_dim,)).astype(np.float32)
                embs.append(v / np.linalg.norm(v))
            return np.stack(embs)

        return hash_encoder


def run_vlm_labeling_chain(
    cfg,
    paths: dict,
    backend=None,
    n_samples: int = 3,
    text_encoder=None,
    query_embs=None,
    device: str | torch.device = "cuda",
):
    """Run stages 1-5 + CLIP segmentation; returns the material PLY path of
    sample_0 (the sim input)."""
    from pixie_tpu_torch.utils.paths import voxel_artifact_paths  # noqa: PLC0415
    from pixie_tpu_torch.voxel.segmentation import generate_material_segmentation  # noqa: PLC0415

    model_name = cfg.get("vlm_model", "gemini-2.0-flash")
    base_dir = Path(paths["vlm_base_dir"])

    if text_encoder is None and query_embs is None:
        text_encoder = _resolve_text_encoder(cfg, device)

    # stage 1: propose parts / ranges / constraints / query candidates
    views = load_training_views(paths["data_dir"])
    seg_agent = SegmentationAgent(
        AgentConfig(model_name, str(base_dir / "seg")),
        obj_class=cfg.obj_class or "object", backend=backend,
    )
    seg_result = seg_agent.generate_prediction(views, overwrite=cfg.overwrite)

    # stage 2: fine (200^3) re-voxelization + per-candidate similarity
    # heatmaps; stage 3: critic pick over them.
    # Offline fallback: first candidate wins when no critic backend.
    heatmaps = viz_seg_candidates(
        paths, seg_result["all_queries"],
        text_encoder=text_encoder, query_embs=query_embs,
        grid_size=int(cfg.segmentation.get("viz_grid_size", 200)),
        softmax_temperature=cfg.segmentation.softmax_temperature,
        overwrite=cfg.overwrite, device=device,
    )
    try:
        from PIL import Image  # noqa: PLC0415

        heat_imgs = [
            [Image.open(p).convert("RGB") for p in heatmaps.get(i, [])]
            for i in range(len(seg_result["all_queries"]))
        ]
        critic = SegmentationCriticAgent(
            AgentConfig(model_name, str(base_dir / "critic")), backend=backend
        )
        critic_result = critic.generate_prediction(
            views, heat_imgs, overwrite=cfg.overwrite,
        )
        best_idx = int(critic_result["best_query"])
    except Exception as e:  # noqa: BLE001
        logging.warning("seg critic unavailable (%s); using query set 0", e)
        best_idx = 0

    # stage 4: one rejection-sampled draw per sample dir
    render_out = Path(paths["render_output"])
    material_plys = []
    for k in range(n_samples):
        sample_dir = render_out / f"sample_{k}"
        sample_dir.mkdir(parents=True, exist_ok=True)
        sampler = MathSamplerAgent(
            AgentConfig("mock-sampler", str(base_dir / f"sample_{k}"))
        )
        seg_json = base_dir / "seg" / SegmentationAgent.OUT_RESULT_PATH
        draw = sampler.generate_prediction(
            str(seg_json), overwrite=cfg.overwrite, seed=k
        )

        # stage 5: merge winning query terms into the draw
        chosen = merge_best_query(draw, seg_result, best_idx)
        (sample_dir / "chosen_vlm_results.json").write_text(
            json.dumps(chosen, indent=2)
        )

        # CLIP text segmentation -> PLY + material grid (training labels)
        art = voxel_artifact_paths(str(render_out))
        result = generate_material_segmentation(
            art["npz"], chosen, sample_dir,
            text_encoder=text_encoder, query_embs=query_embs,
            softmax_temperature=cfg.segmentation.softmax_temperature,
            background_id=cfg.training.background_id, device=device,
        )
        material_plys.append(result["ply"])

    return material_plys[0]
