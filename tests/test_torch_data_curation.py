"""The port's data curation host code (pixie_tpu_torch/data_curation/)
against the JAX package's (pixie_tpu/data_curation/): the similarity
selection equal for the same embedding function, the metadata helpers and
``manual_filter``'s functions and CLI writing the same bytes, and the VLM
filtering's results file with the same canned backend."""

import io
import json
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from pixie_tpu.data_curation import curation as jc
from pixie_tpu.data_curation import manual_filter as jm
from pixie_tpu.vlm_labeler.agent import MockVLM as JMock

from pixie_tpu_torch.data_curation import curation as tc
from pixie_tpu_torch.data_curation import manual_filter as tm
from pixie_tpu_torch.vlm_labeler.agent import MockVLM as TMock

CLASSES = ["tree", "flower", "metal crate", "sand castle", "jelly"]


def _embed(texts):
    """A deterministic embedding: each word's seeded vector, summed."""
    out = []
    for t in texts:
        v = np.zeros(24)
        for w in t.lower().split():
            v += np.random.default_rng(sum(map(ord, w)) * 31 + len(w)).normal(size=24)
        out.append(v)
    return np.asarray(out)


def _names(n=60, seed=0):
    rng = np.random.default_rng(seed)
    words = ["tree", "oak", "flower", "rose", "metal", "crate", "box", "sand", "castle",
             "jelly", "cube", "red", "old", "small"]
    return {f"uid{i:03d}": " ".join(rng.choice(words, size=rng.integers(1, 4)))
            for i in range(n)}


@pytest.mark.parametrize("top_k", [5, 500])
def test_similarity_selection_matches_jax(top_k):
    names = _names()
    got = tc.select_top_objects_by_similarity(names, CLASSES, top_k=top_k, embed_fn=_embed)
    want = jc.select_top_objects_by_similarity(names, CLASSES, top_k=top_k, embed_fn=_embed)
    assert got == want
    assert all(len(v) == min(top_k, len(names)) for v in got.values())


def test_metadata_helpers_write_the_same_bytes(tmp_path):
    cat = tc.select_top_objects_by_similarity(_names(), CLASSES, top_k=7, embed_fn=_embed)
    tc.save_cat_dict(cat, tmp_path / "t" / "cat.json")
    jc.save_cat_dict(cat, tmp_path / "j" / "cat.json")
    assert (tmp_path / "t" / "cat.json").read_bytes() == (tmp_path / "j" / "cat.json").read_bytes()
    meta = {"a": {"obj_class": "tree", "accepted": True}, "b": "flower", "c": {}}
    (tmp_path / "m.json").write_text(json.dumps(meta))
    assert tc.load_obj_metadata(tmp_path / "m.json") == jc.load_obj_metadata(tmp_path / "m.json")
    for k in ("a", "b", "c", "missing"):
        assert tc.get_obj_class_for_id(k, meta) == jc.get_obj_class_for_id(k, meta)


META = {"o1": {"obj_class": "tree", "accepted": True},
        "o2": "flower",
        "o3": {"obj_class": "tree", "accepted": False, "reason": "floating parts"},
        "o4": {"obj_class": "metal_crates"}}


def test_manual_filter_functions_match_jax():
    for status in (None, "accepted", "rejected", "unreviewed"):
        for cls in (None, "tree", "flower"):
            assert tm.filter_objects(META, cls, status) == jm.filter_objects(META, cls, status)
    assert tm.stats(META) == jm.stats(META)
    a, b = json.loads(json.dumps(META)), json.loads(json.dumps(META))
    assert (tm.apply_correction(a, "o2", accepted=False, reason="x")
            == jm.apply_correction(b, "o2", accepted=False, reason="x"))
    assert a == b


COMMANDS = [["accept", "o2", "o4"], ["reject", "o1", "--reason", "too thin"],
            ["reclass", "o3", "shrub"], ["apply", "CORR"], ["stats"],
            ["list"], ["list", "--obj-class", "tree", "--status", "rejected"]]


def _run_cli(main, meta_path, args, corr):
    args = [corr if a == "CORR" else a for a in args]
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        assert main(["--metadata", str(meta_path), *args]) == 0
    return out.getvalue(), err.getvalue().replace(str(meta_path.parent), "<dir>")


def test_manual_filter_cli_writes_the_same_bytes(tmp_path, monkeypatch):
    """Every subcommand in turn on two copies of one metadata file: the
    metadata, the printed lines and the corrections log (its time stamps
    fixed) byte for byte."""
    monkeypatch.setattr(tm.time, "strftime", lambda fmt: "2020-01-01T00:00:00")
    monkeypatch.setattr(jm.time, "strftime", lambda fmt: "2020-01-01T00:00:00")
    corr = tmp_path / "corrections.json"
    corr.write_text(json.dumps({"o4": {"accepted": True, "obj_class": "crate"},
                                "o5": {"obj_class": "jelly"}}))
    paths = {}
    for tag in ("t", "j"):
        (tmp_path / tag).mkdir()
        paths[tag] = tmp_path / tag / "obj_ids_metadata.json"
        paths[tag].write_text(json.dumps(META))
    for cmd in COMMANDS:
        got = _run_cli(tm.main, paths["t"], cmd, str(corr))
        want = _run_cli(jm.main, paths["j"], cmd, str(corr))
        assert got == want, cmd
        assert paths["t"].read_bytes() == paths["j"].read_bytes(), cmd
    log = ".corrections.log"
    assert (paths["t"].parent / (paths["t"].name + log)).read_bytes() == (
        paths["j"].parent / (paths["j"].name + log)).read_bytes()
    assert json.loads(paths["t"].read_text())["o3"]["obj_class"] == "shrub"


def test_vlm_filtering_results_match_jax(tmp_path):
    """run_vlm_filtering over rendered thumbnails with one canned reply a
    call: all_results.json and each object's filter_result.json."""
    from PIL import Image

    dirs = {}
    for k in ("objA", "objB"):
        d = tmp_path / "renders" / k
        d.mkdir(parents=True)
        for i in range(5):
            Image.fromarray(np.full((8, 8, 3), 40 * i, np.uint8)).save(d / f"{i:03d}.png")
        dirs[k] = str(d)
    reply = json.dumps({"is_appropriate": True, "reason": "a clean tree"})
    tc.run_vlm_filtering(dirs, "tree", str(tmp_path / "t"), backend=TMock([reply] * 2), workers=1)
    jc.run_vlm_filtering(dirs, "tree", str(tmp_path / "j"), backend=JMock([reply] * 2), workers=1)
    for rel in ("all_results.json", "objA/filter_result.json", "objB/filter_result.json"):
        assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes(), rel
    assert json.loads((tmp_path / "t" / "all_results.json").read_text())["objA"][
        "is_appropriate"] is True
