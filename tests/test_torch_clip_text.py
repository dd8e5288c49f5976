"""The port's CLIP text path (recon/clip_tokenizer.py, clip_tower.py's
CLIPTextTower, clip_features.encode_text_queries) against Hugging Face's
slow CLIPTokenizer and CLIPModel.get_text_features, and against the JAX
package's encode_text_queries, on seeded local CLIPModel snapshots (a small
seeded BPE vocabulary of the real layout, both pooling rules)."""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from torch_parity import write_clip_model_snapshot

transformers = pytest.importorskip("transformers")

from pixie_tpu_torch.recon.clip_features import (  # noqa: E402
    CLIPWeightsUnavailable, encode_text_queries, load_clip_text,
)
from pixie_tpu_torch.recon.clip_tokenizer import CLIPTokenizer  # noqa: E402
from pixie_tpu_torch.recon.clip_tower import CLIPTextTower, eos_positions  # noqa: E402
from pixie_tpu_torch.vlm_labeler.agent import MOCK_DEFAULT_RESPONSE  # noqa: E402
from pixie_tpu_torch.vlm_labeler.class_instructions import INSTRUCTION_CONFIGS  # noqa: E402


def _library_queries() -> list[str]:
    """Every query string of the class library and of the mock reply."""
    out = []
    for ins in INSTRUCTION_CONFIGS.values():
        out += list(ins.example_material_dict)
        out += [q for qs in ins.example_all_queries for q in qs]
    out += list(MOCK_DEFAULT_RESPONSE["material_dict"])
    out += [q for qs in MOCK_DEFAULT_RESPONSE["all_queries"] for q in qs]
    return sorted(set(out))


QUERIES = _library_queries()
MIXED = ["sand", "rubber duck", "wooden table leg with a long name", "pot", "leaves"]


@pytest.fixture(scope="module", params=[True, False], ids=["argmax_pool", "first_eos_pool"])
def snapshot(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("clip_model")
    write_clip_model_snapshot(d, QUERIES + MIXED, legacy_eos=request.param, n_merges=300,
                              seed=3)
    return d


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip_vocab")
    write_clip_model_snapshot(d, QUERIES, n_merges=400, seed=5)
    return (CLIPTokenizer.from_snapshot(d),
            transformers.CLIPTokenizer(str(d / "vocab.json"), str(d / "merges.txt")))


def test_library_queries_are_many_and_merges_fire(tokenizers):
    ours, _ = tokenizers
    assert len(QUERIES) > 50
    # the learned merges fire: most queries take fewer tokens than bytes
    shorter = sum(len(ours.encode(q)) - 2 < len(q.encode()) for q in QUERIES)
    assert shorter > 0.9 * len(QUERIES)


def test_tokenizer_ids_equal_hf_on_the_library_queries(tokenizers):
    ours, hf = tokenizers
    want = hf(QUERIES, padding=True)["input_ids"]
    np.testing.assert_array_equal(ours(QUERIES), np.asarray(want))
    for q in QUERIES:
        assert ours.encode(q) == hf(q)["input_ids"]


PIECES = ["a", "tree", "Trunk", "LEAVES", "é", "ü", "ñ", "Å", "çà", "3", "42", "0.5", "½",
          "Ⅻ", "ⅷ", "²", "'s", "'S", "'t", "'re", "'VE", "'m", "'ll", "'d", "'x", ".", ",",
          "!", "?", "-", "(", ")", "/", '"', "#", "&", "  ", "\t", "\n", " ", " ",
          " ", "木", "ǅ", "ß", "İ", "ſ", "́", "<|endoftext|>", "😀"]


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.sampled_from(PIECES), min_size=0, max_size=12))
def test_tokenizer_ids_equal_hf_on_mixed_text(tokenizers, parts):
    ours, hf = tokenizers
    text = "".join(parts)
    assert ours.encode(text) == hf(text)["input_ids"], repr(text)


def test_eos_positions_both_rules():
    ids = torch.tensor([[9, 5, 7, 12, 12, 12],      # eos 12 first at 3, then padding
                        [9, 12, 12, 12, 12, 12],
                        [9, 4, 4, 4, 4, 12]])
    np.testing.assert_array_equal(eos_positions(ids, 2).numpy(), [3, 1, 5])
    np.testing.assert_array_equal(eos_positions(ids, 12).numpy(), [3, 1, 5])
    # the first-eos rule reads the id, not the maximum
    np.testing.assert_array_equal(eos_positions(torch.tensor([[9, 7, 12, 5]]), 7).numpy(), [1])


def test_text_tower_matches_hf_get_text_features(snapshot):
    model = transformers.CLIPModel.from_pretrained(snapshot).eval()
    tok = transformers.CLIPTokenizer.from_pretrained(snapshot)
    queries = MIXED + QUERIES[:20]
    inputs = tok(queries, padding=True, return_tensors="pt")
    with torch.no_grad():
        want = model.get_text_features(**inputs).numpy()
    cfg, params, ours_tok = load_clip_text(str(snapshot))
    assert cfg.eos_token_id == model.config.text_config.eos_token_id
    tower = CLIPTextTower(cfg)
    tower.load_state_dict(params)
    ids = ours_tok(queries)
    np.testing.assert_array_equal(ids, inputs["input_ids"].numpy())
    lengths = (ids != ours_tok.pad_id).sum(1)
    assert len(set(lengths.tolist())) >= 3        # queries of mixed lengths in one batch
    with torch.no_grad():
        got = tower(torch.as_tensor(ids)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_encode_text_queries_matches_jax(snapshot):
    from pixie_tpu.recon.clip_features import encode_text_queries as jax_encode

    queries = MIXED + QUERIES[:10]
    want = jax_encode(queries, model_name=str(snapshot))
    got = encode_text_queries(queries, model_name=str(snapshot), device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape == (len(queries), 16)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_missing_snapshot_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    with pytest.raises(CLIPWeightsUnavailable, match="CLIP weights unavailable"):
        encode_text_queries(["pot"], model_name="openai/clip-vit-large-patch14-336",
                            device="cpu")
    # a vision-only snapshot has no tokenizer files: unavailable as well
    from torch_parity import TINY_CLIP, write_clip_snapshot

    with pytest.raises(CLIPWeightsUnavailable):
        load_clip_text(str(write_clip_snapshot(tmp_path / "vision_only", TINY_CLIP)))
