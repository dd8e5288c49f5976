"""The port's VLM labeling chain (pixie_tpu_torch/vlm_labeler/) against the
JAX package's, with MockVLM backends, on the same seeded fixtures on the
CPU: the parser, the agents and their caching, the class library's text,
the sampler's draws, the merge, the hash text encoder, the whole chain's
artifacts, and the port pipeline's ``material_mode=vlm``."""

import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from pixie_tpu.vlm_labeler import agent as jagent
from pixie_tpu.vlm_labeler import chain as jchain
from pixie_tpu.vlm_labeler import class_instructions as jci
from pixie_tpu.vlm_labeler import stages as jstages
from pixie_tpu_torch.vlm_labeler import agent as tagent
from pixie_tpu_torch.vlm_labeler import chain as tchain
from pixie_tpu_torch.vlm_labeler import class_instructions as tci
from pixie_tpu_torch.vlm_labeler import stages as tstages
from test_torch_segmentation import assert_ply_matches

REPO = Path(__file__).resolve().parent.parent

SEG_REPLY = json.dumps({
    "material_dict": {
        "pot": {"density": [300, 500], "E": [1e8, 5e8], "nu": [0.3, 0.4], "material_id": 6},
        "trunk": {"density": [400, 800], "E": [1e6, 5e6], "nu": [0.3, 0.4], "material_id": 1},
        "leaves": {"density": [100, 300], "E": [1e4, 5e4], "nu": [0.3, 0.4], "material_id": 0},
    },
    "reasoning": "the pot holds the tree",
    "constraints": 'assert material_dict["leaves"]["E"] < material_dict["trunk"]["E"]',
    "all_queries": [["pot", "trunk", "leaves"], ["planter", "stem", "foliage"],
                    ["base", "wood", "green"]],
})
CRITIC_REPLY = '```json\n{"scores": {"0": 4, "1": 9, "2": 6}, "best_query": 1, ' \
               '"reasoning": "set 1 separates"}\n```'


@pytest.mark.parametrize("text", [
    'Here you go:\n```json\n{"a": 1}\n```\nthanks', '{"a": {"b": [1, 2]}} trailing',
    'prose {"x": "multi\nline"} more', '```\n{"k": [1, {"z": 2}]}\n```', "no json here",
    '{"open": 1', "```json\n[1, 2]\n```"])
def test_parse_json_block_identical(text):
    def run(fn):
        try:
            return fn(text)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(tagent.parse_json_block) == run(jagent.parse_json_block)


@pytest.mark.parametrize("cls", sorted(jci.INSTRUCTION_CONFIGS))
def test_generate_instruction_text_identical(cls):
    assert set(tci.INSTRUCTION_CONFIGS) == set(jci.INSTRUCTION_CONFIGS)
    for n in (2, 3, 5):
        assert tci.generate_instruction(cls, n) == jci.generate_instruction(cls, n)
    assert tci.INSTRUCTION_FUNCTIONS[cls](3) == jci.INSTRUCTION_FUNCTIONS[cls](3)


def _agent_files(d: Path) -> dict:
    """The agent's outputs that carry no object addresses (prompt.txt prints
    the images' reprs)."""
    return {p.name: p.read_text() for p in sorted(d.iterdir()) if p.name != "prompt.txt"}


@pytest.mark.parametrize("obj_class", ["tree", "chair"])
def test_segmentation_agent_and_caching_identical(tmp_path, obj_class):
    views = [Image.new("RGB", (8, 8), (i * 40, 0, 0)) for i in range(3)]
    out = {}
    for name, ag, st in (("jax", jagent, jstages), ("torch", tagent, tstages)):
        backend = ag.MockVLM([SEG_REPLY])
        a = st.SegmentationAgent(ag.AgentConfig("mock", str(tmp_path / name)), obj_class=obj_class,
                                 backend=backend)
        first = a.generate_prediction(views)
        again = a.generate_prediction(views)          # cached: no second call
        assert again == first and len(backend.calls) == 1
        out[name] = (first, _agent_files(tmp_path / name), backend.calls[0][1])
    assert out["torch"] == out["jax"]
    for name, ag, st in (("jax", jagent, jstages), ("torch", tagent, tstages)):
        with pytest.raises(ValueError, match="all_queries"):
            st.SegmentationAgent(ag.AgentConfig("mock", str(tmp_path / f"bad_{name}")),
                                 obj_class="tree", backend=ag.MockVLM(['{"material_dict": {}}'])
                                 ).generate_prediction(views)


def test_critic_judge_filter_agents_identical(tmp_path):
    for name, ag, st in (("jax", jagent, jstages), ("torch", tagent, tstages)):
        crit = st.SegmentationCriticAgent(ag.AgentConfig("m", str(tmp_path / name / "critic")),
                                          backend=ag.MockVLM([CRITIC_REPLY]))
        assert crit.generate_prediction(["rgb"], [["h0"], ["h1", "h2"]])["best_query"] == 1
        st.PhysicsJudgeAgent(ag.AgentConfig("m", str(tmp_path / name / "judge")),
                             backend=ag.MockVLM(['{"ranking": [1, 0]}'])
                             ).generate_prediction([["f0"], ["f1"]])
        st.DataFilterAgent(ag.AgentConfig("m", str(tmp_path / name / "filter")), "tree",
                           backend=ag.MockVLM()).generate_prediction(["thumb"])
    for sub in ("critic", "judge", "filter"):
        assert _agent_files(tmp_path / "torch" / sub) == _agent_files(tmp_path / "jax" / sub)
    assert tagent.MOCK_DEFAULT_RESPONSE == jagent.MOCK_DEFAULT_RESPONSE
    assert isinstance(tagent.setup_vlm_model("mock-x"), tagent.MockVLM)
    with pytest.raises(ValueError, match="Unknown VLM model"):
        tagent.setup_vlm_model("llama")


@pytest.mark.parametrize("seed", [0, 1, 7, None])
def test_rejection_sample_draws_identical(seed):
    seg = json.loads(SEG_REPLY)
    ranges, cons = seg["material_dict"], seg["constraints"]
    if seed is None:                          # a constraint no draw meets
        for st in (jstages, tstages):
            with pytest.raises(RuntimeError, match="Failed to find valid sample"):
                st.rejection_sample(ranges, "assert False", max_attempts=4)
        return
    assert tstages.rejection_sample(ranges, cons, seed=seed) == \
        jstages.rejection_sample(ranges, cons, seed=seed)
    for c in ("", "```python\nassert True\n```", "raise KeyError('x')",
              'assert material_dict["pot"]["E"] < 0'):
        md = tstages.sample_material_dict(ranges, np.random.default_rng(seed))
        assert tstages.evaluate_constraint(c, md) == jstages.evaluate_constraint(c, md)


def test_merge_best_query_identical():
    seg = json.loads(SEG_REPLY)
    draw = jstages.rejection_sample(seg["material_dict"], "", seed=3)
    for idx in range(3):
        assert tstages.merge_best_query(draw, seg, idx) == jstages.merge_best_query(draw, seg, idx)
    seg["all_queries"].append(["only"])
    for st in (jstages, tstages):
        with pytest.raises(ValueError, match="terms"):
            st.merge_best_query(draw, seg, 3)


@pytest.fixture
def no_clip_weights(tmp_path, monkeypatch):
    """Neither package finds CLIP weights.  JAX's probe would go to the
    Hugging Face hub where ``transformers`` was imported before it could set
    HF_HUB_OFFLINE (as the test files' collection does): its
    ``encode_text_queries`` raises here instead, as it does without a
    snapshot, and the port reads an empty hub cache."""
    from pixie_tpu.recon import clip_features as jclip

    def unavailable(*args, **kwargs):
        raise RuntimeError("CLIP weights unavailable (no local snapshot)")

    monkeypatch.setattr(jclip, "encode_text_queries", unavailable)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty_hub"))


def _cfgs(overrides):
    from pixie_tpu.config import compose as jcompose
    from pixie_tpu_torch.config import compose as tcompose

    return jcompose(overrides=overrides), tcompose(overrides=overrides)


def test_hash_text_encoder_identical(no_clip_weights):
    jcfg, tcfg = _cfgs(["segmentation.allow_hash_text_encoder=true"])
    jenc, tenc = jchain._resolve_text_encoder(jcfg), tchain._resolve_text_encoder(tcfg, "cpu")
    queries = ["pot", "trunk", "leaves", "reddish-brown", ""]
    got, want = tenc(queries), jenc(queries)
    assert got.shape == (5, 768)
    np.testing.assert_array_equal(got, want)
    jcfg, tcfg = _cfgs([])
    assert jchain._resolve_text_encoder(jcfg) is None
    assert tchain._resolve_text_encoder(tcfg, "cpu") is None


def write_object(base: Path, obj: str, d: int, c: int, seed: int = 0):
    """Seeded views (PNGs under data/<obj>) and 64^3-style voxel artifacts
    (render_outputs/<obj>/clip_features*: a ball in three sectors, each
    carrying one of three seeded directions plus noise, float16)."""
    rng = np.random.default_rng(seed)
    data = base / "data" / obj
    data.mkdir(parents=True)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (24, 24, 3), dtype=np.uint8)).save(
            data / f"view_{i:03d}.png")
    q = rng.normal(size=(3, c)).astype(np.float32)
    ijk = np.stack(np.meshgrid(*[np.arange(d)] * 3, indexing="ij"), -1)
    centred = (ijk + 0.5) / d - 0.5
    mask = (np.linalg.norm(centred, axis=-1) < 0.45).astype(np.float32)
    sector = np.digitize(np.arctan2(centred[..., 1], centred[..., 0]), [-np.pi / 3, np.pi / 3])
    feats = q[sector] + 0.3 * rng.normal(size=(d, d, d, c))
    feats = np.where(mask[..., None] > 0, feats, 0.0).astype(np.float16)
    render = base / "render_outputs" / obj
    render.mkdir(parents=True)
    np.save(render / "clip_features_features.npy", feats)
    np.save(render / "clip_features_mask.npy", mask)
    np.save(render / "clip_features_alphas.npy", mask[..., None].astype(np.float16))
    np.save(render / "clip_features_rgb.npy", np.full((d, d, d, 3), 0.5, np.float16))
    np.savez(render / "clip_features.npz", min_bounds=np.full(3, -0.5, np.float32),
             max_bounds=np.full(3, 0.5, np.float32), grid_shape=np.array([d, d, d]),
             voxel_size=np.float32(1.0 / d))
    return q, sector, mask


def _tree_files(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_chain_artifacts_identical_with_mock_vlm(tmp_path):
    """run_vlm_labeling_chain on a 64^3 x 8 fixture, query embeddings
    given: every JSON and npy identical, the PLYs as the segmentation's,
    the heatmaps within one uint8 level, set 1 chosen by the critic."""
    d, c = 64, 8
    roots = {}
    for name, ch, ag in (("jax", jchain, jagent), ("torch", tchain, tagent)):
        base = tmp_path / name
        q, sector, mask = write_object(base, "obj", d, c)
        cfg = _cfgs(["obj_id=obj", "obj_class=tree", f"paths.base_path={base}"])[name == "torch"]
        paths = {"data_dir": str(base / "data" / "obj"),
                 "nerf_output": str(base / "outputs" / "obj" / "f3rm"),
                 "render_output": str(base / "render_outputs" / "obj"),
                 "vlm_base_dir": str(base / "vlm" / "obj")}
        backend = ag.MockVLM([SEG_REPLY, CRITIC_REPLY])
        kw = {"device": "cpu"} if name == "torch" else {}
        ply = ch.run_vlm_labeling_chain(cfg, paths, backend=backend, n_samples=2, query_embs=q,
                                        **kw)
        assert Path(ply) == base / "render_outputs" / "obj" / "sample_0" / "segmented_semantics.ply"
        assert len(backend.calls) == 2
        roots[name] = base
    jroot, troot = roots["jax"], roots["torch"]
    files = _tree_files(jroot)
    assert files == _tree_files(troot)
    heat = [f for f in files if f.endswith(".png") and "vlm" in f]
    assert len(heat) == 9                                 # one a query of each set
    for f in files:
        a, b = troot / f, jroot / f
        if f.endswith(".ply") and "sample_" in f:
            assert_ply_matches(a, b)
        elif f in heat:
            ia, ib = (np.asarray(Image.open(p), np.int16) for p in (a, b))
            assert np.abs(ia - ib).max() <= 1, f
        elif not f.endswith("prompt.txt"):
            assert a.read_bytes() == b.read_bytes(), f
    chosen = json.loads((troot / "render_outputs/obj/sample_1/chosen_vlm_results.json").read_text())
    assert chosen["best_query"] == ["planter", "stem", "foliage"]
    grid = np.load(troot / "render_outputs/obj/sample_0/material_grid.npy")
    ids = grid[..., 3][mask > 0]
    want = np.array([6, 1, 0])[sector[mask > 0]]
    assert (ids == want).mean() > 0.99                    # the sectors' materials


def test_pipeline_main_vlm_mode(tmp_path, no_clip_weights):
    """The port's ``main(material_mode=vlm, vlm_model=mock)`` on the CPU:
    the stages before it skip (no capture; voxel artifacts present), the
    chain runs with MockVLM's default reply and hash embeddings (no CLIP
    snapshot), then one point-cloud frame; its material_grid.npy equals the
    JAX chain's on the same fixture."""
    from pixie_tpu_torch import pipeline

    d, c = 16, 8
    over = ["obj_id=obj", "material_mode=vlm", "obj_class=tree", "+vlm_model=mock",
            "segmentation.allow_hash_text_encoder=true",
            f"training.features.clip.feature_channels={c}",
            f"paths.physgaussian_config_dir={REPO / 'config'}", "physics.n_frames=1",
            "physics.debug=true", "physics.compile_video=false"]
    write_object(tmp_path / "torch", "obj", d, c)
    pipeline.main(over + [f"paths.base_path={tmp_path / 'torch'}"], device="cpu")
    sample = tmp_path / "torch" / "render_outputs" / "obj" / "sample_0"
    sim = tmp_path / "torch" / "mpm_sim_outputs" / "vlm" / "obj" / "sample_0"
    info = json.loads((sim / "sim_info.json").read_text())
    assert info["frames"] == 1 and info["final_state_finite"]

    write_object(tmp_path / "jax", "obj", d, c)
    from pixie_tpu.config import compose
    from pixie_tpu.utils.paths import create_directories, get_output_paths, resolve_paths

    cfg = resolve_paths(compose(overrides=over + [f"paths.base_path={tmp_path / 'jax'}"]))
    paths = get_output_paths(cfg, "obj")
    create_directories(paths)
    jchain.run_vlm_labeling_chain(cfg, paths)
    want = tmp_path / "jax" / "render_outputs" / "obj" / "sample_0"
    for n in ("material_grid.npy", "material_id_grid.npy"):
        assert (sample / n).read_bytes() == (want / n).read_bytes(), n
    assert_ply_matches(sample / "segmented_semantics.ply", want / "segmented_semantics.ply")

    with pytest.raises(ValueError, match="unknown material_mode"):
        pipeline.main(["obj_id=obj", "material_mode=other",
                       f"paths.base_path={tmp_path / 'torch'}"], device="cpu")


def test_viz_candidates_skip_an_empty_fine_grid(tmp_path):
    """A field too thin for the fine grid's alpha threshold leaves its mask
    empty: the candidate viz is skipped (JAX's chain fails on the empty
    array) and the chain goes on without heatmaps."""
    from pixie_tpu_torch.vlm_labeler.chain import viz_seg_candidates

    ro = tmp_path / "render_outputs"
    ro.mkdir()
    np.savez(ro / "clip_features_8.npz", grid_shape=np.array([8, 8, 8]))
    np.save(ro / "clip_features_8_features.npy", np.ones((8, 8, 8, 4), np.float16))
    np.save(ro / "clip_features_8_mask.npy", np.zeros((8, 8, 8), bool))
    out = viz_seg_candidates({"render_output": str(ro), "vlm_base_dir": str(tmp_path / "vlm"),
                              "nerf_output": str(tmp_path / "no_field")},
                             [["a", "b"]], query_embs=np.eye(2, 4, dtype=np.float32),
                             grid_size=8, device="cpu")
    assert out == {}
