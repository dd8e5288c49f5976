"""CLIP's byte-level BPE tokenizer, read from a snapshot's ``vocab.json`` and
``merges.txt``.

It gives the ids of Hugging Face's slow ``CLIPTokenizer`` as the JAX package
calls it (``tok(queries, padding=True)``, pixie_tpu/recon/clip_features.py
``encode_text_queries``): ``<|startoftext|>``, the BPE ids, ``<|endoftext|>``,
then ``<|endoftext|>`` padding up to the longest query.  It follows the path
HF takes without ``ftfy``: ``BasicTokenizer(do_lower_case=True,
strip_accents=False, do_split_on_punc=False)`` cleans the text (control
characters dropped, whitespace to spaces, spaces around CJK characters, NFC,
lower case), then the pre-tokenizer's pattern

    <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+

(case-insensitive) splits it into words, each word's UTF-8 bytes are mapped
to printable characters (``bytes_to_unicode``), its last symbol takes the
``</w>`` suffix, and merges apply lowest rank first.  The ``regex`` package
is not needed: the cleaning drops every character of category C (the
unassigned ones too), and on what remains ``\\p{L}`` and ``\\p{N}`` are the
Unicode categories L* and N*, read from ``unicodedata``.  (Python's
``[^\\W\\d_]`` is not ``\\p{L}``: it also takes numerals such as ``½`` and
``Ⅻ``.)  The fixed alternatives are matched with the standard library's
``re``, case-insensitively as HF's pattern is (``'ſ`` matches ``'s`` in
both).
"""

from __future__ import annotations

import functools
import json
import re
import unicodedata
from pathlib import Path

import numpy as np

BOS, EOS = "<|startoftext|>", "<|endoftext|>"
# HF reads at most this many merges (CLIPTokenizer.__init__: lines 1 ..
# 49152 - 256 - 2 of merges.txt)
MAX_MERGES = 49152 - 256 - 2
_FIXED = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d", re.IGNORECASE)
_SPECIAL = re.compile(r"(<\|startoftext\|>|<\|endoftext\|>)")


@functools.lru_cache
def bytes_to_unicode() -> dict[int, str]:
    """UTF-8 byte -> a printable character (GPT-2's table, as HF's)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> str:
    """HF's ``BasicTokenizer(strip_accents=False, do_split_on_punc=False)``
    tokens joined by spaces."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        out.append(" " if _is_whitespace(ch) else ch)
    text = "".join(f" {ch} " if _is_cjk(ord(ch)) else ch for ch in out)
    words = [w.lower() for w in unicodedata.normalize("NFC", text).split()]
    return " ".join(" ".join(words).split())


def _kind(ch: str) -> str:
    """The pattern's class of a character: letter, number, space or other."""
    cat = unicodedata.category(ch)[0]
    if cat in "LN":
        return cat
    return "S" if ch.isspace() else "P"


def pre_tokenize(text: str) -> list[str]:
    """``re.findall`` of HF's pre-tokenizer pattern over cleaned text."""
    out, i, n = [], 0, len(text)
    while i < n:
        m = _FIXED.match(text, i)
        if m is not None:
            out.append(m.group())
            i = m.end()
            continue
        kind = _kind(text[i])
        j = i + 1
        if kind == "S":
            i = j
            continue
        if kind != "N":           # [\p{L}]+ and [^\s\p{L}\p{N}]+ are greedy runs
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class CLIPTokenizer:
    """``vocab.json`` + ``merges.txt`` -> token ids, as HF's slow
    ``CLIPTokenizer``; an id missing from the vocab is ``<|endoftext|>``'s
    (HF's unknown token)."""

    def __init__(self, vocab_file: str | Path, merges_file: str | Path):
        self.encoder = json.loads(Path(vocab_file).read_text(encoding="utf-8"))
        merges = Path(merges_file).read_text(encoding="utf-8").strip().split("\n")[1:MAX_MERGES + 1]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.cache = {BOS: BOS, EOS: EOS}
        self.bos_id, self.eos_id = self.encoder[BOS], self.encoder[EOS]
        self.pad_id = self.unk_id = self.eos_id

    @classmethod
    def from_snapshot(cls, path: str | Path) -> "CLIPTokenizer":
        path = Path(path)
        return cls(path / "vocab.json", path / "merges.txt")

    def bpe(self, token: str) -> str:
        """Merge a byte-mapped word lowest rank first; its symbols joined by
        spaces (HF's ``CLIPTokenizer.bpe``)."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word, word[1:]))
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda pair: self.bpe_ranks.get(pair, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = set(zip(word, word[1:]))
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> list[str]:
        """The BPE symbols of ``text``; the special tokens written in it stay
        whole, as HF's added-token split keeps them."""
        symbols = []
        for piece in _SPECIAL.split(text):
            if piece in (BOS, EOS):
                symbols.append(piece)
                continue
            for word in pre_tokenize(basic_clean(piece)):
                mapped = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
                symbols.extend(self.bpe(mapped).split(" "))
        return symbols

    def encode(self, text: str) -> list[int]:
        """``<|startoftext|>``, the ids of ``text``, ``<|endoftext|>``."""
        ids = [self.encoder.get(s, self.unk_id) for s in self.tokenize(text)]
        return [self.bos_id, *ids, self.eos_id]

    def __call__(self, queries: list[str]) -> np.ndarray:
        """(Q, longest) int64 ids, each row padded with ``<|endoftext|>``
        (HF's ``padding=True``)."""
        rows = [self.encode(q) for q in queries]
        out = np.full((len(rows), max(map(len, rows))), self.pad_id, np.int64)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r
        return out
