"""The five VLM labeling stages (pixie/vlm_labeler/).

Copied from pixie_tpu/vlm_labeler/stages.py (host only), unchanged apart from its imports.

Stage 1  vlm_seg        — propose part queries + material ranges + constraints
                          from training views (vlm_seg.py:16-59)
Stage 2  viz candidates — CLIP-similarity renders per candidate query set
                          (vlm_viz_seg_candidates.py:10-73)
Stage 3  seg critic     — score query sets 1-10, pick best_query
                          (vlm_seg_critic.py:62-104)
Stage 4  phys sampler   — NO VLM: rejection-sample concrete values from the
                          ranges validating exec'd pythonic constraints
                          (vlm_phys_sampler.py:86-129)
Stage 5  parse critic   — merge best query into each sample
                          (vlm_parse_seg_critic.py:17-88)
Offline  phys judge     — rank rollout videos (vlm_phys_judge.py:50)
"""

from __future__ import annotations

import json
import logging
import os
import textwrap
from pathlib import Path

import numpy as np

from pixie_tpu_torch.sim.types import MATERIAL_ID_TO_NAME, NAME_TO_MATERIAL_ID
from pixie_tpu_torch.vlm_labeler.agent import Agent, parse_json_block

_MATERIAL_LIST = "\n".join(
    f"    {i}: {name}" for i, name in MATERIAL_ID_TO_NAME.items()
    if name not in ("visplas", "fluid")
)


class SegmentationAgent(Agent):
    """Stage 1: propose material_dict ranges, constraints, query candidates."""

    OUT_RESULT_PATH = "vlm_results.json"

    def __init__(self, cfg, obj_class: str, num_alternative_queries: int = 3,
                 backend=None):
        self.obj_class = obj_class
        self.num_alternative_queries = num_alternative_queries
        super().__init__(cfg, backend)

    def _make_system_instruction(self):
        # per-class few-shot instruction library when the class is curated
        # (reference vlm_seg.py:26-27 uses INSTRUCTION_FUNCTIONS[obj_class])
        from pixie_tpu_torch.vlm_labeler.class_instructions import (  # noqa: PLC0415
            INSTRUCTION_FUNCTIONS,
        )

        if self.obj_class in INSTRUCTION_FUNCTIONS:
            return INSTRUCTION_FUNCTIONS[self.obj_class](
                self.num_alternative_queries
            )
        return textwrap.dedent(f"""\
            You label 3D objects of class "{self.obj_class}" with physical
            properties per semantic part: density (kg/m^3), Young's modulus E
            (Pa), Poisson's ratio nu, and a material model id:
{_MATERIAL_LIST}

            A CLIP-based segmentation model will segment the object using
            short text queries, one per part; every part shares one material
            model.  Return value RANGES (e.g. "E": [2e4, 2e6]) rather than
            point values, pythonic assert constraints relating parts (e.g.
            assert material_dict["trunk"]["E"][0] > material_dict["leaf"]["E"][1]),
            and {self.num_alternative_queries} alternative query sets.

            Output exactly one JSON object:
            {{
              "material_dict": {{"<part>": {{"density": [lo, hi],
                 "E": [lo, hi], "nu": [lo, hi], "material_id": <int>}}, ...}},
              "reasoning": "...",
              "constraints": "<python assert lines using material_dict>",
              "all_queries": [["partA", "partB"], ...]
            }}
            """)

    def _make_prompt_parts(self, images):
        return [
            "Here are rendered views of the object. Propose the parts, "
            "material ranges, constraints and query sets.",
            *images,
        ]

    def parse_response(self, text, **kwargs):
        result = parse_json_block(text)
        for key in ("material_dict", "all_queries"):
            if key not in result:
                raise ValueError(f"VLM response missing {key!r}")
        self.save_json(result)


class SegmentationCriticAgent(Agent):
    """Stage 3: score each candidate query set given similarity heatmaps."""

    OUT_RESULT_PATH = "vlm_seg_critic_results.json"

    def _make_system_instruction(self):
        return textwrap.dedent("""\
            You judge CLIP part-segmentation quality.  For each candidate
            query set you see the object's RGB views and per-query similarity
            heatmaps.  Score each set 1-10 on how cleanly the heatmaps
            separate the object's true parts, then pick the best.

            Output exactly one JSON object:
            {"scores": {"<query_set_index>": <score>, ...},
             "best_query": <index int>, "reasoning": "..."}
            """)

    def _make_prompt_parts(self, rgb_images, heatmaps_per_query):
        parts = ["Object RGB views:", *rgb_images]
        for idx, heatmaps in enumerate(heatmaps_per_query):
            parts.append(f"Candidate query set {idx} similarity heatmaps:")
            parts.extend(heatmaps)
        return parts

    def parse_response(self, text, **kwargs):
        result = parse_json_block(text)
        if "best_query" not in result:
            raise ValueError("critic response missing best_query")
        self.save_json(result)


# ---------------------------------------------------------------------------
# Stage 4: pure rejection sampling (no VLM) — vlm_phys_sampler.py:20-129
# ---------------------------------------------------------------------------

def sample_value(range_list, rng) -> float:
    lo, hi = range_list
    return float(lo + (hi - lo) * rng.random())


def sample_material_dict(material_ranges: dict, rng) -> dict:
    out = {}
    for part, props in material_ranges.items():
        out[part] = {
            "density": sample_value(props["density"], rng),
            "E": sample_value(props["E"], rng),
            "nu": sample_value(props["nu"], rng),
            "material_id": props["material_id"],
        }
    return out


def evaluate_constraint(constraint: str, material_dict: dict) -> bool:
    """exec the pythonic assert block against material_dict
    (vlm_phys_sampler.py:30-50)."""
    constraint = (
        constraint.strip().replace("```python", "").replace("```", "").strip()
    )
    if not constraint:
        return True
    try:
        exec(constraint, {"material_dict": material_dict})  # noqa: S102
        return True
    except AssertionError:
        return False
    except Exception as e:  # noqa: BLE001
        logging.warning("Error evaluating constraint: %s", e)
        return False


def rejection_sample(material_ranges: dict, constraints: str,
                     max_attempts: int = 1000, seed: int | None = None) -> dict:
    rng = np.random.default_rng(seed)
    for attempt in range(max_attempts):
        sampled = sample_material_dict(material_ranges, rng)
        if evaluate_constraint(constraints, sampled):
            return {"material_dict": sampled, "sampling_attempts": attempt + 1}
    raise RuntimeError(f"Failed to find valid sample after {max_attempts} attempts")


class MathSamplerAgent(Agent):
    """Stage 4 wrapper with the Agent caching contract."""

    OUT_RESULT_PATH = "vlm_results.json"

    def _make_system_instruction(self):
        return "rejection sampler (no VLM calls)"

    def generate_prediction(self, json_path: str, overwrite: bool = False,
                            max_attempts: int = 1000, seed=None):
        if os.path.exists(self.out_path) and not overwrite:
            return self.load_prediction()
        data = json.loads(Path(json_path).read_text())
        result = rejection_sample(
            data["material_dict"], data.get("constraints", ""),
            max_attempts, seed,
        )
        self.save_json(result)
        return result


# ---------------------------------------------------------------------------
# Stage 5: merge the chosen query into each sample — vlm_parse_seg_critic.py
# ---------------------------------------------------------------------------

def merge_best_query(sample_result: dict, seg_result: dict,
                     best_query_idx: int) -> dict:
    """Rename material_dict keys to the winning query's part terms
    (vlm_parse_seg_critic.py:17-88)."""
    queries = seg_result["all_queries"][best_query_idx]
    mat = sample_result["material_dict"]
    parts = list(mat.keys())
    if len(queries) != len(parts):
        raise ValueError(
            f"query set has {len(queries)} terms but material_dict has "
            f"{len(parts)} parts"
        )
    merged = {q: mat[p] for q, p in zip(queries, parts)}
    return {**sample_result, "material_dict": merged, "best_query": queries}


class PhysicsJudgeAgent(Agent):
    """Offline judge: rank simulation videos for plausibility
    (vlm_phys_judge.py:50)."""

    OUT_RESULT_PATH = "phys_judge_results.json"

    def _make_system_instruction(self):
        return textwrap.dedent("""\
            You judge physical plausibility of simulated object dynamics.
            Rank the candidate videos from most to least physically plausible
            for the object's apparent materials.
            Output one JSON object: {"ranking": [<idx>, ...], "reasoning": "..."}
            """)

    def _make_prompt_parts(self, video_frame_sets):
        parts = []
        for idx, frames in enumerate(video_frame_sets):
            parts.append(f"Candidate simulation {idx}:")
            parts.extend(frames)
        return parts

    def parse_response(self, text, **kwargs):
        self.save_json(parse_json_block(text))


class DataFilterAgent(Agent):
    """Dataset curation: is this rendered object appropriate for its class?
    (vlm_data_filtering.py:15-286)."""

    OUT_RESULT_PATH = "filter_result.json"

    def __init__(self, cfg, obj_class: str, backend=None):
        self.obj_class = obj_class
        super().__init__(cfg, backend)

    def _make_system_instruction(self):
        return (
            f'You check whether a rendered 3D asset is a clean, typical '
            f'instance of the class "{self.obj_class}" suitable for physics '
            f'simulation. Output one JSON object: '
            f'{{"is_appropriate": true/false, "reason": "..."}}'
        )

    def _make_prompt_parts(self, thumbnails):
        return ["Rendered thumbnails:", *thumbnails]

    def parse_response(self, text, **kwargs):
        self.save_json(parse_json_block(text))
