"""VLM agent framework: the vlmx replacement.

Copied from pixie_tpu/vlm_labeler/agent.py (host only), unchanged apart from its imports.

Reference: third_party/vlmx/vlmx/agent.py:23-111 (Agent: system instruction +
prompt parts -> generate_content -> parse_response, with result caching at
OUT_RESULT_PATH and HTML prompt dumps) and prompt_utils.py:44
(``setup_vlm_model`` multiplexing Gemini / Claude / GPT / local Qwen).

Backends are import-guarded: in an offline environment agents raise a clear
error at generation time but the chain structure, caching and parsing are
all testable with the ``MockVLM`` backend.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from pathlib import Path


@dataclasses.dataclass
class AgentConfig:
    model_name: str
    out_dir: str
    api_key: str | None = None


class VLMBackend:
    """generate(prompt_parts: list[str | PIL.Image], system: str) -> text."""

    def generate(self, prompt_parts, system_instruction):  # pragma: no cover
        raise NotImplementedError


# superset of every stage's required keys, so a bare MockVLM satisfies the
# whole labeling chain offline (stage schemas: stages.py parse_response)
MOCK_DEFAULT_RESPONSE = {
    "material_dict": {
        "body": {"density": [300, 800], "E": [1e5, 1e6], "nu": [0.3, 0.4],
                 "material_id": 0},
    },
    "all_queries": [["object"], ["body"]],
    "constraints": "",
    "best_query": 0,
    "reasoning": "mock",
    "scores": [1.0],
    "is_appropriate": True,
    "best_sample": 0,
}


class MockVLM(VLMBackend):
    """Deterministic canned-response backend for tests/offline runs.

    Without injected responses it replies with a schema-valid superset
    JSON (MOCK_DEFAULT_RESPONSE) so every chain stage parses."""

    def __init__(self, responses=None):
        self.responses = list(responses or [])
        self.calls = []

    def generate(self, prompt_parts, system_instruction):
        self.calls.append((prompt_parts, system_instruction))
        if self.responses:
            return self.responses.pop(0)
        import json  # noqa: PLC0415

        return json.dumps(MOCK_DEFAULT_RESPONSE)


def setup_vlm_model(model_name: str, api_key: str | None = None) -> VLMBackend:
    """Multiplex backends by model-name prefix (prompt_utils.py:44-340)."""
    name = model_name.lower()
    if name.startswith("mock"):
        return MockVLM()
    if name.startswith("gemini"):
        return _GeminiBackend(model_name, api_key)
    if name.startswith("claude"):
        return _ClaudeBackend(model_name, api_key)
    if name.startswith(("gpt", "o1", "o3")):
        return _OpenAIBackend(model_name, api_key)
    if name.startswith("qwen"):
        return _QwenBackend(model_name)
    raise ValueError(f"Unknown VLM model {model_name!r}")


class _GeminiBackend(VLMBackend):
    def __init__(self, model_name, api_key):
        import google.generativeai as genai  # noqa: PLC0415

        genai.configure(api_key=api_key or os.environ.get("GEMINI_API_KEY"))
        self.model_name = model_name
        self._genai = genai

    def generate(self, prompt_parts, system_instruction):
        model = self._genai.GenerativeModel(
            self.model_name, system_instruction=system_instruction
        )
        return model.generate_content(prompt_parts).text


class _ClaudeBackend(VLMBackend):
    def __init__(self, model_name, api_key):
        import anthropic  # noqa: PLC0415

        self.client = anthropic.Anthropic(
            api_key=api_key or os.environ.get("ANTHROPIC_API_KEY")
        )
        self.model_name = model_name

    def generate(self, prompt_parts, system_instruction):
        content = []
        for part in prompt_parts:
            if isinstance(part, str):
                content.append({"type": "text", "text": part})
            else:  # PIL image
                import base64
                import io

                buf = io.BytesIO()
                part.save(buf, format="PNG")
                content.append(
                    {
                        "type": "image",
                        "source": {
                            "type": "base64",
                            "media_type": "image/png",
                            "data": base64.b64encode(buf.getvalue()).decode(),
                        },
                    }
                )
        msg = self.client.messages.create(
            model=self.model_name, max_tokens=8192,
            system=system_instruction,
            messages=[{"role": "user", "content": content}],
        )
        return msg.content[0].text


class _OpenAIBackend(VLMBackend):
    def __init__(self, model_name, api_key):
        import openai  # noqa: PLC0415

        self.client = openai.OpenAI(api_key=api_key or os.environ.get("OPENAI_API_KEY"))
        self.model_name = model_name

    def generate(self, prompt_parts, system_instruction):
        content = []
        for part in prompt_parts:
            if isinstance(part, str):
                content.append({"type": "text", "text": part})
            else:
                import base64
                import io

                buf = io.BytesIO()
                part.save(buf, format="PNG")
                content.append(
                    {
                        "type": "image_url",
                        "image_url": {
                            "url": "data:image/png;base64,"
                            + base64.b64encode(buf.getvalue()).decode()
                        },
                    }
                )
        resp = self.client.chat.completions.create(
            model=self.model_name,
            messages=[
                {"role": "system", "content": system_instruction},
                {"role": "user", "content": content},
            ],
        )
        return resp.choices[0].message.content


class _QwenBackend(VLMBackend):
    """Local Qwen2.5-VL via transformers (prompt_utils.py local path)."""

    def __init__(self, model_name):
        from transformers import AutoModelForVision2Seq, AutoProcessor  # noqa: PLC0415

        self.processor = AutoProcessor.from_pretrained(model_name)
        self.model = AutoModelForVision2Seq.from_pretrained(model_name)

    def generate(self, prompt_parts, system_instruction):
        text = "\n".join(p for p in prompt_parts if isinstance(p, str))
        images = [p for p in prompt_parts if not isinstance(p, str)]
        inputs = self.processor(
            text=f"{system_instruction}\n{text}", images=images or None,
            return_tensors="pt",
        )
        out = self.model.generate(**inputs, max_new_tokens=4096)
        return self.processor.batch_decode(out, skip_special_tokens=True)[0]


class Agent:
    """Base agent: system instruction + prompt parts -> parsed, cached result.

    Subclasses define OUT_RESULT_PATH, _make_system_instruction,
    _make_prompt_parts and parse_response (vlmx/agent.py contract).
    """

    OUT_RESULT_PATH = "result.json"

    def __init__(self, cfg: AgentConfig, backend: VLMBackend | None = None):
        self.cfg = cfg
        Path(cfg.out_dir).mkdir(parents=True, exist_ok=True)
        self.system_instruction = self._make_system_instruction()
        (Path(cfg.out_dir) / "system_instruction.txt").write_text(
            str(self.system_instruction)
        )
        self.model = backend if backend is not None else setup_vlm_model(
            cfg.model_name, cfg.api_key
        )

    @property
    def out_path(self) -> str:
        return os.path.join(self.cfg.out_dir, self.OUT_RESULT_PATH)

    def _make_system_instruction(self):
        raise NotImplementedError

    def _make_prompt_parts(self, *args, **kwargs):
        raise NotImplementedError

    def parse_response(self, text: str, **kwargs):
        raise NotImplementedError

    def generate_prediction(self, *args, overwrite: bool = False, **kwargs):
        if os.path.exists(self.out_path) and not overwrite:
            logging.info(
                "%s: prediction exists at %s, skipping",
                type(self).__name__, self.out_path,
            )
            return self.load_prediction()
        prompt_parts = self._make_prompt_parts(*args, **kwargs)
        dump = "\n".join(str(p)[:500] for p in prompt_parts)
        (Path(self.cfg.out_dir) / "prompt.txt").write_text(dump)
        text = self.model.generate(prompt_parts, self.system_instruction)
        self.parse_response(text, **kwargs)
        return self.load_prediction()

    def load_prediction(self):
        if self.OUT_RESULT_PATH.endswith(".json"):
            return json.loads(Path(self.out_path).read_text())
        return Path(self.out_path).read_text()

    def save_json(self, obj):
        Path(self.out_path).write_text(json.dumps(obj, indent=2))


def parse_json_block(text: str) -> dict:
    """Extract the first JSON object from a model response (handles ```json
    fences and leading prose)."""
    text = text.strip()
    if "```" in text:
        for chunk in text.split("```"):
            chunk = chunk.strip()
            if chunk.startswith("json"):
                chunk = chunk[4:]
            chunk = chunk.strip()
            if chunk.startswith("{"):
                text = chunk
                break
    start = text.find("{")
    if start < 0:
        raise ValueError("no JSON object in response")
    depth = 0
    for i, ch in enumerate(text[start:], start):
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                return json.loads(text[start : i + 1], strict=False)
    raise ValueError("unbalanced JSON in response")
