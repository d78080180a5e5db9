"""Input processors (counterpart of the JAX package's ``processing.py``;
reference src/model/vla/processing.py), a numpy copy.

Prompt format (PaliGemma): 256 ``<image>`` tokens + ``<bos>`` +
instruction + ``\\n``, right-padded to max_seq_len = 276 (reference :9-22,
:96-136). Images: uint8 -> [0, 1] rescale -> (x - 0.5) / 0.5, emitted in
NHWC, the model's layout.

The tokenizer is injected. The PaliGemma tokenizer itself needs
``transformers``, which the card's machine does not have, so
``load_paligemma_tokenizer`` raises (ROADMAP.md, "Not queued") and
``FakeTokenizer`` (a word-level stand-in with the protocol
``VLAProcessor`` needs) serves tests and smoke runs. The single-image
``PaliGemmaProcessor`` (PIL) waits with the text-generation CLI.
"""

from __future__ import annotations

from typing import List

import numpy as np

IMAGE_TOKEN = "<image>"
IMAGENET_STANDARD_MEAN = 0.5
IMAGENET_STANDARD_STD = 0.5


def process_images(images: np.ndarray) -> np.ndarray:
    """uint8 [B, H, W, C] -> float32 [-1, 1] (rescale + normalize,
    reference processing.py:25-60)."""
    if images.dtype != np.uint8:
        raise ValueError(f"expected uint8 images, got {images.dtype}")
    # multiply by the reciprocal (not /255) — byte-identical to the
    # reference's float32 rescale (processing.py:25-30), so pixel values fed
    # at eval match the training distribution bit-for-bit
    x = images.astype(np.float32) * np.float32(1.0 / 255.0)
    return (x - IMAGENET_STANDARD_MEAN) / IMAGENET_STANDARD_STD


def add_image_tokens_to_prompt(
    prefix_prompt: str, bos_token: str, image_seq_len: int, image_token: str = IMAGE_TOKEN
) -> str:
    """<image>*N + <bos> + prompt + \\n (reference processing.py:9-22; the
    trailing newline is part of PaliGemma's training format)."""
    return f"{image_token * image_seq_len}{bos_token}{prefix_prompt}\n"


def _setup_paligemma_tokenizer(tokenizer):
    """Register the <image>/<loc*>/<seg*> extra tokens and disable auto
    bos/eos (shared by VLAProcessor and PaliGemmaProcessor)."""
    tokenizer.add_special_tokens({"additional_special_tokens": [IMAGE_TOKEN]})
    tokenizer.add_tokens(
        [f"<loc{i:04d}>" for i in range(1024)]
        + [f"<seg{i:03d}>" for i in range(128)]
    )
    tokenizer.add_bos_token = False
    tokenizer.add_eos_token = False
    return tokenizer.convert_tokens_to_ids(IMAGE_TOKEN)


class VLAProcessor:
    """Tokenize instruction prompts and normalize images
    (reference processing.py:63-136)."""

    def __init__(
        self,
        tokenizer,
        num_image_tokens: int,
        max_seq_len: int,
        tokenizer_padding: str = "max_length",
    ):
        self.image_seq_length = num_image_tokens
        self.max_seq_len = max_seq_len
        self.tokenizer_padding = tokenizer_padding
        self.image_token_id = _setup_paligemma_tokenizer(tokenizer)
        self.tokenizer = tokenizer

    def __call__(
        self, text: List[str], images: np.ndarray, truncation: bool = True
    ) -> dict:
        """images: uint8 [B, H, W, C]. Returns {pixel_values f32 NHWC,
        input_ids i32 [B, max_seq_len], attention_mask i32}."""
        if len(images) != len(text):
            raise ValueError(f"received {len(images)} images for {len(text)} prompts")
        pixel_values = process_images(np.asarray(images))
        strings = [
            add_image_tokens_to_prompt(t, self.tokenizer.bos_token, self.image_seq_length)
            for t in text
        ]
        enc = self.tokenizer(
            strings,
            return_tensors="np",
            max_length=self.max_seq_len,
            padding=self.tokenizer_padding,
            truncation=truncation,
        )
        return {
            "pixel_values": pixel_values,
            "input_ids": np.asarray(enc["input_ids"], np.int32),
            "attention_mask": np.asarray(enc["attention_mask"], np.int32),
        }


def load_paligemma_tokenizer(path_or_repo: str):
    """The PaliGemma tokenizer needs the ``transformers`` package, which the
    card's machine does not have: not ported (ROADMAP.md, "Not queued").
    Tests and smoke runs take ``FakeTokenizer``."""
    raise NotImplementedError(
        f"{path_or_repo}: loading the PaliGemma tokenizer needs transformers, which the port does not "
        "use; the PaliGemma tokenizer is not queued in ROADMAP.md, since it needs a download (FakeTokenizer stands in)"
    )


class FakeTokenizer:
    """Minimal offline stand-in implementing the protocol VLAProcessor
    needs (hermetic tests / smoke runs without hub access). Word-level
    vocabulary built on the fly; ids: 0=<pad>, 1=<eos>, 2=<bos>."""

    def __init__(self, image_token_id: int = 257152):
        self.vocab = {"<pad>": 0, "<eos>": 1, "<bos>": 2, "\n": 3}
        self._image_token_id = image_token_id
        self._next_word_id = 100
        self.bos_token = "<bos>"
        self.eos_token = "<eos>"
        self.add_bos_token = False
        self.add_eos_token = False

    def add_special_tokens(self, d):
        for tok in d.get("additional_special_tokens", []):
            if tok == IMAGE_TOKEN:
                self.vocab[tok] = self._image_token_id

    def add_tokens(self, toks):
        for t in toks:
            self.vocab.setdefault(t, 10_000 + len(self.vocab))

    def convert_tokens_to_ids(self, tok):
        return self.vocab[tok]

    def _encode(self, s: str) -> List[int]:
        ids = []
        rest = s
        n_img = 0
        while rest.startswith(IMAGE_TOKEN):
            n_img += 1
            rest = rest[len(IMAGE_TOKEN):]
        ids.extend([self.vocab[IMAGE_TOKEN]] * n_img)
        if rest.startswith(self.bos_token):
            ids.append(self.vocab["<bos>"])
            rest = rest[len(self.bos_token):]
        newline = rest.endswith("\n")
        if newline:
            rest = rest[:-1]
        for w in rest.split():
            # stable word ids from a counter (hash() varies per process via
            # PYTHONHASHSEED); never hand out the image token id
            if w not in self.vocab:
                nxt = self._next_word_id
                if nxt == self._image_token_id:
                    nxt += 1
                self.vocab[w] = nxt
                self._next_word_id = nxt + 1
            ids.append(self.vocab[w])
        if newline:
            ids.append(self.vocab["\n"])
        return ids

    def __call__(self, strings, return_tensors, max_length, padding, truncation):
        rows = [self._encode(s) for s in strings]
        if truncation:
            rows = [r[:max_length] for r in rows]
        width = max_length if padding == "max_length" else max(map(len, rows))
        ids = np.zeros((len(rows), width), np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return {"input_ids": ids, "attention_mask": mask}
