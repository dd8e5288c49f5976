"""Dataset curation: Objaverse selection, download, VLM filtering, HF sync
(port of pixie_tpu/data_curation/curation.py; host code, no kernels).

Reference: data_curation/objaverse_selection.py:14-90 (SentenceTransformer
name-vs-class cosine top-500), download_objaverse.py, vlm_data_filtering.py,
scripts/{download,upload}_data.py (HF hub snapshot sync of the vlongle/pixie
dataset).  All stages are network-dependent and import-gated; the selection
scoring itself is pure math and testable offline with injected embeddings
(the port's ``recon.clip_tokenizer`` + ``recon.clip_tower`` text encoder
fits as ``embed_fn``).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np


def select_top_objects_by_similarity(
    object_names: dict[str, str],
    class_names: list[str],
    top_k: int = 500,
    embed_fn=None,
) -> dict[str, list[str]]:
    """Cosine-similarity selection of object names per class
    (objaverse_selection.py:14-90).

    embed_fn: list[str] -> (N, D) embeddings.  Defaults to
    sentence-transformers all-MiniLM-L6-v2 when installed; inject a callable
    for offline use.
    """
    if embed_fn is None:
        try:
            from sentence_transformers import SentenceTransformer  # noqa: PLC0415

            model = SentenceTransformer("all-MiniLM-L6-v2")
            embed_fn = lambda texts: model.encode(texts)
        except Exception as e:  # noqa: BLE001
            raise RuntimeError(
                f"sentence-transformers unavailable ({e}); pass embed_fn"
            ) from e

    uids = list(object_names.keys())
    name_emb = np.asarray(embed_fn([object_names[u] for u in uids]), np.float32)
    cls_emb = np.asarray(embed_fn(class_names), np.float32)
    name_emb /= np.maximum(np.linalg.norm(name_emb, axis=1, keepdims=True), 1e-8)
    cls_emb /= np.maximum(np.linalg.norm(cls_emb, axis=1, keepdims=True), 1e-8)
    sims = name_emb @ cls_emb.T  # (N, C)

    cat_dict = {}
    for ci, cls in enumerate(class_names):
        order = np.argsort(-sims[:, ci])[:top_k]
        cat_dict[cls] = [uids[i] for i in order]
    return cat_dict


def save_cat_dict(cat_dict: dict, path: str | Path):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(cat_dict, indent=2))


def download_objaverse_objects(uids: list[str], processes: int = 8):
    """Download GLBs (download_objaverse.py; requires network)."""
    import objaverse  # noqa: PLC0415

    return objaverse.load_objects(uids, download_processes=processes)


def load_obj_metadata(path: str | Path) -> dict:
    """config/obj_ids_metadata.json loader: {obj_id: {obj_class, ...}}."""
    return json.loads(Path(path).read_text())


def get_obj_class_for_id(obj_id: str, metadata: dict) -> str | None:
    entry = metadata.get(obj_id)
    return entry.get("obj_class") if isinstance(entry, dict) else entry


# -- HF hub sync (scripts/download_data.py / upload_data.py) ------------------

def download_data(repo_id: str = "vlongle/pixie", local_dir: str = ".",
                  allow_patterns=None):
    from huggingface_hub import snapshot_download  # noqa: PLC0415

    return snapshot_download(
        repo_id=repo_id, repo_type="dataset", local_dir=local_dir,
        allow_patterns=allow_patterns,
    )


def upload_data(local_dir: str, repo_id: str = "vlongle/pixie",
                path_in_repo: str = ".", token: str | None = None):
    from huggingface_hub import HfApi  # noqa: PLC0415

    api = HfApi(token=token)
    api.create_repo(repo_id, repo_type="dataset", exist_ok=True)
    return api.upload_folder(
        folder_path=local_dir, repo_id=repo_id, repo_type="dataset",
        path_in_repo=path_in_repo,
    )


def run_vlm_filtering(render_dirs: dict[str, str], obj_class: str, out_dir: str,
                      model_name: str = "gemini-2.0-flash", backend=None,
                      workers: int = 4) -> dict:
    """VLM appropriateness filtering over rendered thumbnails
    (vlm_data_filtering.py:15-286)."""
    from concurrent.futures import ThreadPoolExecutor  # noqa: PLC0415

    from PIL import Image  # noqa: PLC0415

    from pixie_tpu_torch.vlm_labeler.agent import AgentConfig  # noqa: PLC0415
    from pixie_tpu_torch.vlm_labeler.stages import DataFilterAgent  # noqa: PLC0415

    def judge(item):
        obj_id, render_dir = item
        thumbs = [Image.open(p) for p in sorted(Path(render_dir).glob("*.png"))[:4]]
        agent = DataFilterAgent(
            AgentConfig(model_name, str(Path(out_dir) / obj_id)),
            obj_class=obj_class, backend=backend,
        )
        try:
            return obj_id, agent.generate_prediction(thumbs)
        except Exception as e:  # noqa: BLE001
            logging.warning("filtering failed for %s: %s", obj_id, e)
            return obj_id, {"is_appropriate": None, "reason": str(e)}

    with ThreadPoolExecutor(workers) as ex:
        results = dict(ex.map(judge, render_dirs.items()))
    Path(out_dir, "all_results.json").write_text(json.dumps(results, indent=2))
    return results
