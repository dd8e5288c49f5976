"""Per-class VLM segmentation instruction library (stage 1 few-shot prompts).

Copied from pixie_tpu/vlm_labeler/class_instructions.py (host only), unchanged apart from its imports.

Reproduces the reference's curated per-class prompt payloads
(pixie/vlm_labeler/vlm_seg_class_instruction.py:15-374): for each of the 11
labeled object classes, a few-shot example material_dict, alternative query
sets, class tips, optional constraint examples and dataset notes.  These
curated values are the substance of labeling quality — the ranges/ids below
match the reference's so the produced PixieVerse-style labels are
distribution-compatible.

``generate_instruction(class_name, num_alternative_queries)`` renders the
full system instruction (SYSTEM_INSTRUCTION_TEMPLATE +
PART_QUERY_INSTRUCTION_TEMPLATE, reference :268-341);
``INSTRUCTION_FUNCTIONS`` mirrors the reference's registry (:369-374).
"""

from __future__ import annotations

import dataclasses
import json
import textwrap

from pixie_tpu_torch.sim.types import MATERIAL_ID_TO_NAME, get_material_id

_JELLY = get_material_id("jelly")
_METAL = get_material_id("metal")
_SAND = get_material_id("sand")
_SNOW = get_material_id("snow")
_STATIONARY = get_material_id("stationary")


@dataclasses.dataclass(frozen=True)
class ClassInstruction:
    """Curated few-shot payload for one object class."""

    example_material_dict: dict
    example_all_queries: list
    tips: list
    class_name_for_example: str = ""
    special_notes: str = ""
    example_explanation: str = ""
    example_constraints: str = "..."


INSTRUCTION_CONFIGS: dict[str, ClassInstruction] = {
    "tree": ClassInstruction(
        class_name_for_example="ficus tree",
        example_material_dict={
            "pot": {"density": 400, "E": 2e8, "nu": 0.4, "material_id": _STATIONARY},
            "trunk": {"density": 400, "E": 2e6, "nu": 0.4, "material_id": _JELLY},
            "leaves": {"density": 200, "E": 2e4, "nu": 0.4, "material_id": _JELLY},
        },
        example_explanation=(
            "The pot is stationary; trunk and leaves are \"jelly\" so they "
            "sway in the wind, with the trunk much stiffer than the leaves."
        ),
        example_all_queries=[["leaves", "trunk", "pot"],
                             ["green", "orange", "reddish-brown"]],
        tips=[
            "A scene typically has a stationary part fixing the object to the "
            "ground — usually the pot or base of the tree; set its "
            "material_id to 6. If there is no stationary part, never mind.",
            "For numerical stability, `E` should be between 1e4 and 1e6.",
            "Higher `E` means stiffer — a stiffer tree sways less in the wind.",
        ],
        example_constraints=textwrap.dedent("""\
            assert material_dict["leaves"]["density"] < material_dict["trunk"]["density"] < material_dict["pot"]["density"], "The density of the leaves should be less than the trunk and the pot"
            assert material_dict["leaves"]["E"] < material_dict["trunk"]["E"] < material_dict["pot"]["E"], "The stiffness of the leaves should be less than the trunk and the pot"
        """),
    ),
    "flowers": ClassInstruction(
        class_name_for_example="flowers in a vase",
        example_material_dict={
            "vase": {"density": 500, "E": 1e6, "nu": 0.3, "material_id": _STATIONARY},
            "flowers": {"density": 100, "E": 1e4, "nu": 0.4, "material_id": _JELLY},
        },
        example_explanation=(
            "The vase is stationary (material_id=6); the flowers are pliable "
            "\"jelly\" (0) so they can sway, with the vase far stiffer."
        ),
        example_all_queries=[["vase", "flowers"], ["ceramic base", "petals"],
                             ["blue vase", "pink flower"]],
        example_constraints=textwrap.dedent("""\
            assert material_dict["vase"]["density"] > material_dict["flowers"]["density"], "The density of the vase should be greater than the flowers"
            assert material_dict["vase"]["E"] > material_dict["flowers"]["E"], "The stiffness of the vase should be greater than the flowers"
        """),
        tips=[
            "In a typical flower arrangement the vase (or base) is "
            "stationary: give that part material_id=6 if present.",
            "For numerical stability, `E` should roughly be between 1e4 and 1e6.",
            "Higher `E` = stiffer, so the vase needs a higher E range than "
            "the flowers.",
        ],
    ),
    "shrub": ClassInstruction(
        class_name_for_example="typical three-part shrub",
        special_notes=(
            "**Dataset note:** shrubs in our dataset stand by themselves — "
            "there is **no planter or base** — so return only the shrub's "
            "structural parts and mark none of them stationary."
        ),
        example_material_dict={
            "stems": {"density": 300, "E": 1e5, "nu": 0.35, "material_id": _JELLY},
            "twigs": {"density": 250, "E": 6e4, "nu": 0.38, "material_id": _JELLY},
            "foliage": {"density": 150, "E": 2e4, "nu": 0.40, "material_id": _JELLY},
        },
        example_explanation=(
            "Return *ranges* instead of single values, with reasoning, "
            "pythonic constraints and alternative query lists."
        ),
        example_all_queries=[
            ["stems", "twigs", "foliage"],
            ["woody stems", "thin branches", "leaves"],
            ["brown sticks", "small branches", "green leaves"],
        ],
        tips=[
            "Provide exactly the parts visible (usually stems/twigs + foliage).",
            "1e4 <= E <= 1e6.",
            "Stems should be stiffest > twigs > foliage.",
            "No part uses material_id 6 because nothing is fixed to the ground.",
        ],
    ),
    "grass": ClassInstruction(
        special_notes=(
            "**Dataset note:** grass patches are usually isolated; "
            "occasionally a visible soil patch is underneath. Include a "
            "\"soil\" part only if it is visible."
        ),
        example_material_dict={
            "blades": {"density": 80, "E": 1e4, "nu": 0.45, "material_id": _JELLY},
        },
        example_explanation=textwrap.dedent("""\
            Example A (typical isolated grass — no stationary part):
            ```json
            {"blades": {"density": 80, "E": 1e4, "nu": 0.45, "material_id": 0}}
            ```

            Example B (grass with visible soil):
            ```json
            {"soil":   {"density": 1200, "E": 5e5, "nu": 0.30, "material_id": 6},
             "blades": {"density":   80, "E": 1e4, "nu": 0.45, "material_id": 0}}
            ```
            Return *ranges*, reasoning, constraints and alternative query lists.
        """),
        example_all_queries=[["blades"], ["grass"], ["green stalks"]],
        tips=[
            "Segment only the visible parts (sometimes just \"blades\").",
            "If *no* soil visible:\nall_queries: [[\"blades\"],[\"grass\"],"
            "[\"green stalks\"]]",
            "If soil *is* visible:\nall_queries: [[\"soil\", \"blades\"],"
            "[\"dirt\", \"grass\"],[\"brown base\", \"green grass\"]]",
            "1e4 <= E <= 1e6.",
            "If soil present -> give it material_id 6 and ensure "
            "E_soil > E_blades.",
            "If soil absent -> no stationary part; material_id 6 should not "
            "appear.",
        ],
    ),
    "rubber_ducks_and_toys": ClassInstruction(
        special_notes=(
            "IMPORTANT: treat the entire object as ONE part — do not segment "
            "it. The object is a single, bouncy rubber-like body."
        ),
        example_material_dict={
            "toy": {"density": [80, 150], "E": [3e4, 5e4], "nu": [0.4, 0.45],
                    "material_id": _JELLY},
        },
        example_all_queries=[["toy"], ["rubber toy"], ["yellow duck"],
                             ["plastic toy"]],
        tips=[
            "Always use material_id=0 (jelly) for bouncy rubber-like behavior",
            "Keep E relatively low (around 1e3) for good bounce",
            "Density should be in the range of typical rubber/plastic toys",
            "Poisson's ratio should be around 0.35 for rubber-like behavior",
            "Make sure all queries in all_queries list are single-part queries",
        ],
    ),
    "sport_balls": ClassInstruction(
        special_notes=(
            "IMPORTANT: treat the entire ball as ONE part — do not segment "
            "surface patterns or seams. The ball is a single bouncy body."
        ),
        example_material_dict={
            "ball": {"density": [80, 150], "E": [3e4, 5e4], "nu": [0.4, 0.45],
                     "material_id": _JELLY},
        },
        example_all_queries=[["ball"], ["sport ball"], ["basketball"],
                             ["round ball"]],
        tips=[
            "Always use material_id=0 (jelly) for bouncy behavior",
            "Keep E relatively low (around 1e3) for good bounce",
            "Density should be in the range of typical sport balls",
            "Poisson's ratio should be around 0.35 for rubber-like behavior",
            "Make sure all queries in all_queries list are single-part queries",
        ],
    ),
    "soda_cans": ClassInstruction(
        special_notes=(
            "IMPORTANT: treat the entire can as ONE part — do not segment "
            "top, body, or label. The can is a single rigid metal body."
        ),
        example_material_dict={
            "can": {"density": [2600, 2800], "E": [5e10, 8e10],
                    "nu": [0.25, 0.35], "material_id": _METAL},
        },
        example_all_queries=[["can"], ["soda can"], ["aluminum can"],
                             ["metal can"]],
        tips=[
            "Always use material_id=1 (metal) for rigid metal behavior",
            "Keep E relatively high (around 1e8) for metal stiffness",
            "Density should be in the range of typical aluminum "
            "(around 2700 kg/m^3)",
            "Poisson's ratio should be around 0.3 for metal behavior",
            "Make sure all queries in all_queries list are single-part queries",
        ],
    ),
    "metal_crates": ClassInstruction(
        special_notes=(
            "IMPORTANT: treat the entire crate as ONE part — do not segment "
            "sides, top, or bottom. The crate is a single rigid metal body."
        ),
        example_material_dict={
            "crate": {"density": [2500, 2900], "E": [8e7, 1.2e8],
                      "nu": [0.25, 0.35], "material_id": _METAL},
        },
        example_all_queries=[["crate"], ["metal crate"], ["metal box"],
                             ["steel crate"]],
        tips=[
            "Always use material_id=1 (metal) for rigid metal behavior",
            "Keep E relatively high (around 1e8) for metal stiffness",
            "Density should be in the range of typical metal "
            "(around 2700 kg/m^3)",
            "Poisson's ratio should be around 0.3 for metal behavior",
            "Make sure all queries in all_queries list are single-part queries",
        ],
    ),
    "sand": ClassInstruction(
        special_notes=(
            "IMPORTANT: treat the entire object as ONE part — sand is a "
            "single granular material."
        ),
        example_material_dict={
            "sand": {"density": [1800, 2200], "E": [4e7, 6e7],
                     "nu": [0.25, 0.35], "material_id": _SAND},
        },
        example_all_queries=[["sand"], ["sand pile"], ["sand mound"],
                             ["granular material"]],
        tips=[
            "Always use material_id=2 (sand) for granular behavior",
            "Keep E relatively high (around 5e7) for sand stiffness",
            "Density should be in the range of typical sand "
            "(around 2000 kg/m^3)",
            "Poisson's ratio should be around 0.3 for sand behavior",
            "Make sure all queries in all_queries list are single-part queries",
        ],
    ),
    "jello_block": ClassInstruction(
        special_notes=(
            "IMPORTANT: treat the entire object as ONE part — the jello "
            "block is a single soft, bouncy body."
        ),
        example_material_dict={
            "jello": {"density": [40, 60], "E": [800, 1200],
                      "nu": [0.25, 0.35], "material_id": _JELLY},
        },
        example_all_queries=[["jello"], ["jello block"], ["gelatin"],
                             ["bouncy block"]],
        tips=[
            "Always use material_id=0 (jelly) for soft, bouncy behavior",
            "Keep E relatively low (around 1000) for good bounce and jiggle",
            "Density should be in the range of typical jello "
            "(around 50 kg/m^3)",
            "Poisson's ratio should be around 0.3 for jello-like behavior",
            "Make sure all queries in all_queries list are single-part queries",
        ],
    ),
    "snow_and_mud": ClassInstruction(
        special_notes=(
            "IMPORTANT: treat the combined snow & mud mixture as ONE "
            "deformable part — do **not** split it into separate snow and "
            "mud regions; the simulation uses one MPM material."
        ),
        example_material_dict={
            "snow_and_mud": {"density": [2000, 3000], "E": [8e4, 1.2e5],
                             "nu": [0.15, 0.25], "material_id": _SNOW},
        },
        example_all_queries=[["snow and mud"], ["slush"], ["muddy snow"],
                             ["wet snow"]],
        tips=[
            "Always set material_id = 5 (snow) so the simulator uses the "
            "elasto-plastic snow model.",
            "Keep E around 1e5 (the config value) to match the intended "
            "softness.",
            "Density is markedly higher than fluffy snow because of the "
            "mud/water content — use roughly 2-3 g/cm^3 (2000-3000 kg/m^3).",
            "Make sure every list in `all_queries` contains **one** phrase "
            "because this is a single-part object.",
        ],
    ),
}


SYSTEM_INSTRUCTION_TEMPLATE = textwrap.dedent("""\
    We are labeling a 3D object with physical properties:
    - Density
    - Young's Modulus
    - Poisson's Ratio
    - Material model

    where the material model is one of:
{material_list_str}

    An automatic semantic segmentation model segments the object into parts;
    every part shares one material model.  Your job: propose the part queries
    to pass to the segmentation model and the material properties per part.
    {special_notes}
    For example, for a {class_name_for_example}, the return is

    ```json
    {example_material_dict_str}
    ```
    {example_explanation}
    Many different property values are valid and change how the object
    behaves, so return a RANGE per value like "E": [2e4, 2e6] instead of a
    point value, plus reasoning and constraints where appropriate.

    Output a json of the form:

    ```json
    {{
        "material_dict": {{ ... like the example but with ranges ... }},
        "reasoning": "...",
        "constraints": "...",
        "all_queries": "..."
    }}
    ```

    Write constraints as python code, for example:
    ```python
    {example_constraints_str}
    ```

    You return ranges, so `material_dict["<part>"]["density"]` is a range —
    but write the constraints as if each entry were already a single value
    (our sampler draws a value from each range BEFORE running your
    constraints).  Never index the range like
    `material_dict["<part>"]["density"][0]`; write
    `material_dict["<part>"]["density"]` instead.
""")

PART_QUERY_INSTRUCTION_TEMPLATE = textwrap.dedent("""\
    You will see images of the object from one or more views.  Propose part
    queries that match what is VISIBLE: if the object has no visible trunk or
    pot, do not include them in the material_dict.

    Because the CLIP segmentation model is imperfect, also provide
    alternative query sets (including the original) in all_queries, e.g.
    ```json
    {example_all_queries_str}
    ```
    Provide {num_alternative_queries} alternative queries in total.

    Tips:
{tips_str}
    - Make sure each element of `all_queries` is in the exact same order as
      the material_dict keys.
""")


def generate_instruction(class_name: str, num_alternative_queries: int) -> str:
    """Render the stage-1 system instruction for one object class
    (reference generate_instruction, vlm_seg_class_instruction.py:341-366)."""
    config = INSTRUCTION_CONFIGS[class_name]
    material_list_str = "\n".join(
        f'        {i}: "{name}",' for i, name in MATERIAL_ID_TO_NAME.items()
    )
    system = SYSTEM_INSTRUCTION_TEMPLATE.format(
        material_list_str=material_list_str,
        special_notes=config.special_notes,
        class_name_for_example=config.class_name_for_example or class_name,
        example_material_dict_str=json.dumps(config.example_material_dict, indent=4),
        example_explanation=config.example_explanation,
        example_constraints_str=config.example_constraints,
    )
    part_query = PART_QUERY_INSTRUCTION_TEMPLATE.format(
        num_alternative_queries=num_alternative_queries,
        example_all_queries_str=json.dumps(config.example_all_queries, indent=4),
        tips_str="\n".join(f"    - {tip}" for tip in config.tips),
    )
    return system + part_query


INSTRUCTION_FUNCTIONS = {
    class_name: (lambda c: lambda n: generate_instruction(c, n))(class_name)
    for class_name in INSTRUCTION_CONFIGS
}
