"""RLDS (TFDS-format) episodes, read and written without TensorFlow
(counterpart of the JAX package's ``data/rlds.py``).

The on-disk format is TFDS's: ``features.json`` (the feature schema),
``dataset_info.json`` (the splits' shard lengths) and TFRecord shards
``<name>-<split>.tfrecord-<i>-of-<n>``. Each episode is one
``tf.train.Example`` whose nested feature keys are "/"-joined, and whose
step-level tensors are flattened ([T, *dims] -> T * prod(dims) values in
one float, int64 or bytes list). Images stay encoded (decoded later, in the
frame transforms).

An episode reads back as the JAX reader's ``as_numpy_iterator`` gives it:
nested dicts; step leaves with a leading [T]; images and strings as object
arrays of bytes; float leaves as float32 (a float64 leaf too: the wire
format holds floats); bool as bool; the narrower ints as their dtype;
int64 as int64.

Where the port differs: the JAX reader's episode order depends on its
parallel reads; the port reads the shards one after another in their
order, and ``shuffle`` draws from an explicit ``np.random.Generator``
through a buffer of 1000 episodes.
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from open_pi_zero_torch.data import tf_example, tfrecord
from open_pi_zero_torch.data.streams import ordered_map, shuffle_buffer

FEATURES_FILE = "features.json"
INFO_FILE = "dataset_info.json"
EPISODE_SHUFFLE_BUFFER = 1000
_NARROW_INTS = ("int8", "int16", "int32", "uint8", "uint16", "uint32")


@dataclass
class LeafSpec:
    key: str  # flattened "/"-joined key
    dtype: str  # original dtype string
    shape: Tuple[int, ...]  # per-step shape (excl. the step axis)
    kind: str  # "tensor" | "image" | "text"
    in_steps: bool = False
    encoding_format: Optional[str] = None  # for images


@dataclass
class DatasetSpec:
    name: str
    leaves: List[LeafSpec] = field(default_factory=list)
    splits: Dict[str, List[int]] = field(default_factory=dict)  # shard lengths

    def num_episodes(self, split: str) -> int:
        return sum(self.splits[split])


# --------------------------------------------------------------------------- #
# features.json parsing (TFDS schema)
# --------------------------------------------------------------------------- #


def _walk_features(node: dict, prefix: str, in_steps: bool, out: List[LeafSpec]):
    cls = node.get("pythonClassName", "")
    if "FeaturesDict" in cls or "featuresDict" in node:
        for name, sub in node["featuresDict"]["features"].items():
            key = f"{prefix}/{name}" if prefix else name
            _walk_features(sub, key, in_steps, out)
    elif "sequence" in node or "Sequence" in cls or "Dataset" in cls:
        inner = node["sequence"]["feature"]
        _walk_features(inner, prefix, True, out)
    elif "image" in node or "Image" in cls:
        img = node.get("image", {})
        dims = [int(d) for d in img.get("shape", {}).get("dimensions", [])]
        out.append(
            LeafSpec(
                key=prefix,
                dtype=img.get("dtype", "uint8"),
                shape=tuple(dims),
                kind="image",
                in_steps=in_steps,
                encoding_format=img.get("encodingFormat", "png"),
            )
        )
    elif "text" in node or "Text" in cls:
        out.append(LeafSpec(prefix, "string", (), "text", in_steps))
    elif "tensor" in node or "Tensor" in cls or "Scalar" in cls:
        t = node.get("tensor", {})
        dims = [int(d) for d in t.get("shape", {}).get("dimensions", [])]
        out.append(LeafSpec(prefix, t.get("dtype", "float32"), tuple(dims), "tensor", in_steps))
    else:
        raise ValueError(f"unsupported feature node at {prefix!r}: {cls}")


def load_spec(data_dir: str) -> DatasetSpec:
    with open(os.path.join(data_dir, FEATURES_FILE)) as f:
        features = json.load(f)
    with open(os.path.join(data_dir, INFO_FILE)) as f:
        info = json.load(f)
    leaves: List[LeafSpec] = []
    _walk_features(features, "", False, leaves)
    splits = {s["name"]: [int(n) for n in s["shardLengths"]] for s in info.get("splits", [])}
    return DatasetSpec(name=info.get("name", "dataset"), leaves=leaves, splits=splits)


def parse_split(split: str, total: int) -> Tuple[str, int, int]:
    """'train' | 'train[:95%]' | 'train[95%:]' | 'train[1:3]' ->
    (name, start, end). Percent bounds are over total episodes (TFDS
    sub-split convention)."""
    m = re.match(r"^(\w+)$", split)
    if m:
        return split, 0, total
    m = re.match(r"^(\w+)\[(\d+%?)?:(\d+%?)?\]$", split)
    if not m:
        raise ValueError(f"cannot parse split spec {split!r}")
    name, a, b = m.group(1), m.group(2), m.group(3)

    def bound(tok, default):
        if tok is None:
            return default
        if tok.endswith("%"):
            return int(total * int(tok[:-1]) / 100)
        return int(tok)

    return name, bound(a, 0), bound(b, total)


def shard_files(data_dir: str, spec: DatasetSpec, split_name: str) -> List[str]:
    n = len(spec.splits[split_name])
    return [
        os.path.join(data_dir, f"{spec.name}-{split_name}.tfrecord-{i:05d}-of-{n:05d}")
        for i in range(n)
    ]


# --------------------------------------------------------------------------- #
# reading
# --------------------------------------------------------------------------- #


def _restore_leaf(kind: str, values, leaf: LeafSpec):
    """A parsed feature -> [T, *shape] (or [*shape] for non-step leaves), in
    the dtype the JAX reader gives."""
    if leaf.kind == "image" or leaf.dtype == "string":
        if kind != tf_example.BYTES and len(values):
            raise ValueError(f"feature {leaf.key!r} holds {kind}, want bytes")
        out = np.empty(len(values), object)
        out[:] = list(values)
        return out  # [T] encoded bytes / strings
    want = tf_example.FLOAT if leaf.dtype in ("float32", "float64") else tf_example.INT64
    if kind != want and len(values):
        raise ValueError(f"feature {leaf.key!r} holds {kind}, want {want}")
    if not len(values):
        values = np.zeros(0, np.float32 if want == tf_example.FLOAT else np.int64)
    shape = list(leaf.shape)
    if leaf.in_steps:
        shape = [-1] + shape
    x = np.asarray(values).reshape(shape)
    if leaf.dtype == "bool":
        x = x != 0
    elif leaf.dtype in _NARROW_INTS:
        x = x.astype(leaf.dtype)
    return x


def _unflatten(flat: Dict[str, object]) -> dict:
    out: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = val
    return out


def decode_episode(serialized: bytes, spec: DatasetSpec) -> dict:
    """One serialized episode -> its nested dict (every leaf of the spec;
    a missing one is empty, as a VarLenFeature reads it)."""
    features = tf_example.parse_example(serialized)
    flat = {}
    for leaf in spec.leaves:
        kind, values = features.get(leaf.key, (tf_example.BYTES, []))
        flat[leaf.key] = _restore_leaf(kind, values, leaf)
    return _unflatten(flat)


def episode_dataset(
    data_dir: str,
    split: str = "train",
    spec: Optional[DatasetSpec] = None,
    shuffle: bool = False,
    rng: Optional[np.random.Generator] = None,
    num_parallel_reads: int = 1,
) -> Iterator[dict]:
    """Nested episode dicts of ``split``, in shard order (a sub-split takes
    episodes by their position in that order), shuffled through a buffer of
    1000 with ``rng`` if ``shuffle``; records are decoded on
    ``num_parallel_reads`` threads, in order."""
    spec = spec or load_spec(data_dir)
    base = split.split("[")[0]
    name, start, end = parse_split(split, spec.num_episodes(base))
    records = itertools.islice(tfrecord.iter_records(shard_files(data_dir, spec, name)), start, end)
    if shuffle:
        if rng is None:
            raise ValueError("shuffle needs an explicit rng")
        records = shuffle_buffer(records, EPISODE_SHUFFLE_BUFFER, rng)
    return ordered_map(functools.partial(decode_episode, spec=spec), records, num_parallel_reads)


# --------------------------------------------------------------------------- #
# writing (tests, chip_smoke.py and demo writers)
# --------------------------------------------------------------------------- #


def _feature_json(leaf: LeafSpec) -> dict:
    if leaf.kind == "image":
        return {
            "pythonClassName": "tensorflow_datasets.core.features.image_feature.Image",
            "image": {
                "shape": {"dimensions": [str(d) for d in leaf.shape]},
                "dtype": leaf.dtype,
                "encodingFormat": leaf.encoding_format or "png",
            },
        }
    if leaf.kind == "text":
        return {
            "pythonClassName": "tensorflow_datasets.core.features.text_feature.Text",
            "text": {},
        }
    return {
        "pythonClassName": "tensorflow_datasets.core.features.tensor_feature.Tensor",
        "tensor": {
            "shape": {"dimensions": [str(d) for d in leaf.shape]},
            "dtype": leaf.dtype,
        },
    }


def _nest_features_json(leaves: List[LeafSpec]) -> dict:
    step_tree: dict = {}
    top_tree: dict = {}
    for leaf in leaves:
        tree = step_tree if leaf.in_steps else top_tree
        parts = leaf.key.split("/")
        # step leaves are stored under "steps/..." flattened keys
        if leaf.in_steps and parts[0] == "steps":
            parts = parts[1:]
        cur = tree
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = _feature_json(leaf)

    def to_features_dict(tree: dict) -> dict:
        feats = {}
        for k, v in tree.items():
            if "pythonClassName" in v:
                feats[k] = v
            else:
                feats[k] = to_features_dict(v)
        return {
            "pythonClassName": "tensorflow_datasets.core.features.features_dict.FeaturesDict",
            "featuresDict": {"features": feats},
        }

    root = to_features_dict(top_tree)
    root["featuresDict"]["features"]["steps"] = {
        "pythonClassName": "tensorflow_datasets.core.features.dataset_feature.Dataset",
        "sequence": {"feature": to_features_dict(step_tree)},
    }
    return root


def _flatten(d: dict, prefix: str = "") -> Dict[str, object]:
    out = {}
    for k, v in d.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def encode_episode(ep: dict, leaves: List[LeafSpec]) -> bytes:
    """One episode (nested dict; step leaves with a leading [T]) -> a
    serialized ``tf.train.Example``, as the JAX writer builds it."""
    leaf_map = {l.key: l for l in leaves}
    feats = {}
    for key, val in _flatten(ep).items():
        leaf = leaf_map[key]
        if leaf.kind in ("image", "text") or leaf.dtype == "string":
            vals = np.atleast_1d(np.asarray(val, dtype=object))
            feats[key] = (tf_example.BYTES, [v if isinstance(v, bytes) else str(v).encode() for v in vals])
        elif leaf.dtype in ("float32", "float64"):
            feats[key] = (tf_example.FLOAT, np.asarray(val, np.float32).reshape(-1))
        else:
            feats[key] = (tf_example.INT64, np.asarray(val).astype(np.int64).reshape(-1))
    return tf_example.serialize_example(feats)


def write_rlds_dataset(
    data_dir: str,
    name: str,
    episodes: Iterable[dict],
    leaves: List[LeafSpec],
    split: str = "train",
    shards: int = 1,
    num_episodes: Optional[int] = None,
):
    """Write episodes (nested dicts; step leaves have leading [T]) in the
    TFDS RLDS layout this module reads. Given ``num_episodes``, the
    episodes are streamed: each is encoded and written as it comes, and
    the iterable must yield exactly that many."""
    if num_episodes is None:
        episodes = list(episodes)
        num_episodes = len(episodes)
    os.makedirs(data_dir, exist_ok=True)
    per_shard = [num_episodes // shards] * shards
    for i in range(num_episodes % shards):
        per_shard[i] += 1
    stream = iter(episodes)
    written = 0
    for si, n in enumerate(per_shard):
        path = os.path.join(data_dir, f"{name}-{split}.tfrecord-{si:05d}-of-{shards:05d}")
        with tfrecord.TFRecordWriter(path) as w:
            for ep in itertools.islice(stream, n):
                w.write(encode_episode(ep, leaves))
                written += 1
    if written != num_episodes or next(stream, None) is not None:
        raise ValueError(f"{name}/{split}: {num_episodes} episodes promised, "
                         f"{written if written < num_episodes else 'more'} given")

    with open(os.path.join(data_dir, FEATURES_FILE), "w") as f:
        json.dump(_nest_features_json(leaves), f)
    info = {
        "name": name,
        "splits": [{"name": split, "shardLengths": [str(n) for n in per_shard]}],
    }
    info_path = os.path.join(data_dir, INFO_FILE)
    if os.path.exists(info_path):
        with open(info_path) as f:
            old = json.load(f)
        old_splits = [s for s in old.get("splits", []) if s["name"] != split]
        info["splits"] = old_splits + info["splits"]
    with open(info_path, "w") as f:
        json.dump(info, f)
