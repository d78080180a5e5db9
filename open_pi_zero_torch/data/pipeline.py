"""Dataset assembly: one RLDS dataset's trajectories, and the weighted
interleave of several into frames (counterpart of the JAX package's
``data/pipeline.py``; reference src/data/dataset.py:257-604), on the host
in numpy and threads, where the JAX package runs ``tf.data``.

The interleave keeps the JAX package's order of operations: statistics ->
weights balanced by transitions -> repeat -> trajectory transforms ->
flatten -> weighted sampling -> frame shuffle (of encoded frames) -> frame
transforms (decode, resize, augment) [-> batch].

Every draw comes from a generator seeded from ``seed``: each dataset's
episode shuffle and subsample from (seed, dataset index, ...), the
sampling and the frame shuffle from (seed, ...), each frame's transforms
from (seed, frame index). Threads only map in order (``streams``), so a
dataset iterated twice from its seed yields the same frames in the same
order. A shard (``FrameDataset.frames(index, count)``: every count-th
frame from ``index``, JAX's ``ds.shard`` before the batch) is taken before
the frame transforms, each frame drawing from its index in the whole
stream, so a process transforms only its own frames. The JAX package's order is not fixed: its parallel reads and maps
interleave by timing.
"""

from __future__ import annotations

import inspect
import itertools
import os
from functools import partial
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from open_pi_zero_torch.data import normalization as norm_lib
from open_pi_zero_torch.data import obs_transforms, rlds, traj_transforms
from open_pi_zero_torch.data.streams import one_blas_thread, ordered_map, shuffle_buffer

REQUIRED_KEYS = {"observation", "action"}
AUTOTUNE = -1  # tf.data.AUTOTUNE: the port takes the host's core count
_SAMPLING, _FRAME_SHUFFLE = 1, 2  # the interleave's generators: (seed, which)


def _threads(n: Optional[int]) -> int:
    if n is None or n == AUTOTUNE:
        return os.cpu_count() or 1
    return max(1, int(n))


def _strings(value: bytes, n: int) -> np.ndarray:
    out = np.empty(n, object)
    out[:] = [value] * n
    return out


def _fingerprint(kwargs: dict) -> str:
    fn = kwargs.get("standardize_fn")
    fn_src = ""
    if fn is not None:
        try:
            fn_src = inspect.getsource(fn)
        except (OSError, TypeError):
            # source unavailable (partial / C impl): use a stable identity,
            # never repr() — its memory address would bust the cache every run
            fn_src = f"{getattr(fn, '__module__', '')}.{getattr(fn, '__qualname__', type(fn).__name__)}"
    parts = [
        kwargs.get("name", ""),
        str(sorted((kwargs.get("image_obs_keys") or {}).items())),
        str(kwargs.get("proprio_obs_key")),
        fn_src,
    ]
    return "|".join(parts)


class Trajectories:
    """The trajectories of one RLDS dataset, re-iterable: each iteration
    reads the split again from the start, its episode order (when
    shuffled) drawn from a generator seeded with ``seed``; with ``repeat``
    endless, each pass in a new order."""

    def __init__(self, read_pass: Callable[[Optional[np.random.Generator]], Iterator[dict]],
                 seed, shuffle: bool, repeat: bool = False):
        self._read_pass, self.seed, self.shuffle, self.repeat = read_pass, seed, shuffle, repeat

    def repeated(self) -> "Trajectories":
        return Trajectories(self._read_pass, self.seed, self.shuffle, repeat=True)

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed) if self.shuffle else None
        while True:
            n = 0
            for traj in self._read_pass(rng):
                n += 1
                yield traj
            if not self.repeat:
                return
            if n == 0:
                raise ValueError("cannot repeat an empty dataset")


def make_dataset_from_rlds(
    name: str,
    data_dir: str,
    *,
    train: bool = True,
    split: Optional[str] = None,
    standardize_fn: Optional[Callable] = None,
    image_obs_keys: Dict[str, Optional[str]] = None,
    depth_obs_keys: Optional[Dict[str, Optional[str]]] = None,
    proprio_obs_key: Optional[str] = None,
    language_key: Optional[str] = None,
    action_proprio_normalization_type: str = norm_lib.BOUNDS,
    dataset_statistics: Optional[dict] = None,
    action_normalization_mask: Optional[Sequence[bool]] = None,
    skip_norm: bool = False,
    num_parallel_reads: int = AUTOTUNE,
    num_parallel_calls: int = AUTOTUNE,
    seed=0,
    statistics_cache_dir: Optional[str] = None,
) -> Tuple[Trajectories, dict]:
    """RLDS dir -> (trajectories in the canonical layout, statistics).

    Canonical trajectory layout (reference restructure, dataset.py:346-396):
      observation: image_<view> (encoded bytes), proprio [T, P], timestep
      task: language_instruction
      action: [T, A] float32, dataset_name
    """
    ds_dir = data_dir if os.path.exists(os.path.join(data_dir, rlds.FEATURES_FILE)) else os.path.join(data_dir, name)
    spec = rlds.load_spec(ds_dir)
    image_obs_keys = image_obs_keys or {}

    if split is None:
        if "val" in spec.splits:
            split = "train" if train else "val"
        else:
            split = "train[:95%]" if train else "train[95%:]"

    def restructure(ep: dict) -> dict:
        steps = ep["steps"]
        # action stays RAW here: for RT-1-family datasets it is a nested
        # dict that only the standardize_fn flattens (reference
        # dataset.py:346-357)
        traj = {"observation": dict(steps.get("observation", {})), "action": steps["action"]}
        if "language_instruction" in steps:
            traj["language_instruction"] = steps["language_instruction"]
        if standardize_fn is not None:
            traj = standardize_fn(traj)
        if not REQUIRED_KEYS <= set(traj):
            raise ValueError(f"standardize_fn must produce keys {REQUIRED_KEYS}")
        action = np.asarray(traj["action"], np.float32)

        traj_len = len(action)
        old_obs = traj["observation"]
        new_obs = {}
        for new, old in image_obs_keys.items():
            new_obs[f"image_{new}"] = _strings(b"", traj_len) if old is None else old_obs[old]
        for new, old in (depth_obs_keys or {}).items():
            new_obs[f"depth_{new}"] = _strings(b"", traj_len) if old is None else old_obs[old]
        if proprio_obs_key is not None:
            new_obs["proprio"] = np.asarray(old_obs[proprio_obs_key], np.float32)
        new_obs["timestep"] = np.arange(traj_len, dtype=np.int32)

        task = {}
        if language_key is not None:
            lang = traj.get(language_key)
            if lang is None:
                lang = traj["observation"].get(language_key)
            if lang is None:
                lang = _strings(b"", traj_len)
            task["language_instruction"] = lang

        return {
            "observation": new_obs,
            "task": task,
            "action": action,
            "dataset_name": _strings(name.encode(), traj_len),
        }

    def read_pass(split_: str, normalize: bool, stats: Optional[dict], rng) -> Iterator[dict]:
        episodes = rlds.episode_dataset(ds_dir, split=split_, spec=spec, shuffle=rng is not None, rng=rng,
                                        num_parallel_reads=_threads(num_parallel_reads))
        trajs = ordered_map(restructure, episodes, _threads(num_parallel_calls))
        trajs = (t for t in trajs if len(t["action"]) > 0)
        if normalize:
            norm = partial(
                norm_lib.normalize_traj, stats=stats, normalization_type=action_proprio_normalization_type,
                action_mask=action_normalization_mask,
            )
            trajs = map(norm, trajs)
        return trajs

    if dataset_statistics is None:
        dataset_statistics = norm_lib.get_or_compute_statistics(
            read_pass("train", False, None, None),
            ds_dir,
            _fingerprint({
                "name": name, "image_obs_keys": image_obs_keys,
                "proprio_obs_key": proprio_obs_key, "standardize_fn": standardize_fn,
            }),
            cache_dir=statistics_cache_dir,
        )

    trajectories = Trajectories(
        lambda rng: read_pass(split, not skip_norm, dataset_statistics, rng), seed, shuffle=train,
    )
    return trajectories, dataset_statistics


def apply_trajectory_transforms(
    trajectories: Iterable[dict],
    *,
    train: bool,
    window_size: int = 1,
    action_horizon: int = 1,
    subsample_length: Optional[int] = None,
    skip_unlabeled: bool = False,
    max_action: Optional[float] = None,
    max_proprio: Optional[float] = None,
    max_action_dim: Optional[int] = None,
    max_proprio_dim: Optional[int] = None,
    num_parallel_calls: int = AUTOTUNE,
    rng: Optional[np.random.Generator] = None,
) -> Iterator[dict]:
    """Filters + pad-mask bookkeeping + chunking + subsample
    (reference dataset.py:32-175); ``rng`` draws the subsample."""
    ds: Iterable[dict] = trajectories
    if skip_unlabeled:
        ds = filter(traj_transforms.has_language, ds)
    if max_action is not None:
        ds = filter(partial(traj_transforms.within_action_bounds, max_action=max_action), ds)
    if max_proprio is not None:
        ds = filter(partial(traj_transforms.within_proprio_bounds, max_proprio=max_proprio), ds)

    def xform(traj: dict) -> dict:
        traj = traj_transforms.add_pad_mask_dict(traj)
        traj = traj_transforms.pad_actions_and_proprio(traj, max_action_dim=max_action_dim,
                                                       max_proprio_dim=max_proprio_dim)
        return traj_transforms.chunk_act_obs(traj, window_size=window_size, action_horizon=action_horizon)

    ds = ordered_map(xform, ds, _threads(num_parallel_calls))
    if train and subsample_length is not None:
        if rng is None:
            raise ValueError("subsample needs an explicit rng")
        ds = (traj_transforms.subsample(t, subsample_length, rng) for t in ds)
    return ds


def apply_frame_transforms(
    frames: Iterable[dict],
    *,
    train: bool,
    resize_size: Dict[str, Tuple[int, int]],
    image_augment_kwargs: Optional[Dict[str, dict]] = None,
    image_dropout_prob: float = 0.0,
    num_parallel_calls: int = AUTOTUNE,
    seed: int = 0,
    shard: Tuple[int, int] = (0, 1),
) -> Iterator[dict]:
    """Per-frame decode/resize/augment, frame i's draws from a generator
    seeded with (seed, i) (reference dataset.py:178-254), of the frames of
    the shard ``(index, count)``: frames index, index + count, ..."""

    def xform(indexed) -> dict:
        i, frame = indexed
        return obs_transforms.apply_obs_transforms(
            frame,
            rng=np.random.default_rng([seed, i]),
            resize_size=resize_size,
            image_augment_kwargs=image_augment_kwargs,
            image_dropout_prob=image_dropout_prob,
            train=train,
        )

    index, count = shard
    return ordered_map(xform, itertools.islice(enumerate(frames), index, None, count), _threads(num_parallel_calls))


def sample_from_datasets(streams: List[Iterator], weights: Sequence[float], rng: np.random.Generator) -> Iterator:
    """Each element from a stream drawn by ``weights``; an exhausted stream
    leaves the draw, the others' weights renormalized
    (``tf.data.Dataset.sample_from_datasets``)."""
    active = list(range(len(streams)))
    weights = np.asarray(weights, np.float64)
    while active:
        p = weights[active] / weights[active].sum()
        j = active[int(rng.choice(len(active), p=p))]
        try:
            yield next(streams[j])
        except StopIteration:
            active.remove(j)


def _stack(values: list):
    if isinstance(values[0], dict):
        return {k: _stack([v[k] for v in values]) for k in values[0]}
    if isinstance(values[0], (bytes, str)):
        out = np.empty(len(values), object)
        out[:] = values
        return out
    return np.stack(values)


def batch_frames(frames: Iterable[dict], batch_size: int) -> Iterator[dict]:
    """Frames stacked into batches of ``batch_size`` (the remainder
    dropped); strings into object arrays of bytes, as tf.data batches
    them."""
    batch = []
    for frame in frames:
        batch.append(frame)
        if len(batch) == batch_size:
            yield _stack(batch)
            batch = []


class FrameDataset:
    """The interleaved frames of ``make_interleaved_dataset``: each
    iteration starts again from the seed. ``sample_weights`` and
    ``dataset_statistics`` as the JAX package's dataset carries them."""

    def __init__(self, make_frames: Callable[[int, int], Iterator[dict]], batch_size: Optional[int],
                 sample_weights: List[float], dataset_statistics: List[dict]):
        self._make_frames, self.batch_size = make_frames, batch_size
        self.sample_weights, self.dataset_statistics = sample_weights, dataset_statistics

    def frames(self, index: int = 0, count: int = 1) -> Iterator[dict]:
        """The frames of shard ``index`` of ``count`` (every count-th frame
        of the stream from ``index``), unbatched; numpy's BLAS runs on one
        thread from here on (``streams.one_blas_thread``)."""
        if not 0 <= index < count:
            raise ValueError(f"shard {index} of {count}")
        one_blas_thread()
        return self._make_frames(index, count)

    def __iter__(self) -> Iterator[dict]:
        frames = self.frames()
        return batch_frames(frames, self.batch_size) if self.batch_size is not None else frames


def make_interleaved_dataset(
    dataset_kwargs_list: List[dict],
    sample_weights: Optional[List[float]] = None,
    *,
    train: bool = True,
    split: Optional[str] = None,
    shuffle_buffer_size: int = 10_000,
    batch_size: Optional[int] = None,
    balance_weights: bool = True,
    traj_transform_kwargs: Optional[dict] = None,
    frame_transform_kwargs: Optional[dict] = None,
    traj_transform_threads: Optional[int] = None,
    traj_read_threads: Optional[int] = None,
    seed: int = 0,
) -> FrameDataset:
    """Weight-balanced interleave of several RLDS datasets
    (reference make_interleaved_dataset, dataset.py:484-604):
    per-dataset stats -> weights (balanced by transition count) ->
    repeat -> traj transforms -> flatten -> sample_from_datasets ->
    shuffle -> frame transforms [-> batch]."""
    sample_weights = list(sample_weights or [1.0] * len(dataset_kwargs_list))
    if len(sample_weights) != len(dataset_kwargs_list):
        raise ValueError(f"{len(sample_weights)} weights for {len(dataset_kwargs_list)} datasets")
    traj_transform_kwargs = dict(traj_transform_kwargs or {})
    frame_transform_kwargs = dict(frame_transform_kwargs or {})

    # pass 1: statistics (cached)
    all_stats = []
    for kw in dataset_kwargs_list:
        _, stats = make_dataset_from_rlds(
            **{k: v for k, v in kw.items() if k != "action_normalization_mask"},
            train=train, split=split,
        )
        all_stats.append(stats)

    if balance_weights:
        sizes = np.asarray([s["num_transitions"] for s in all_stats], np.float64)
        sample_weights = list(np.asarray(sample_weights) * sizes)
    total = sum(sample_weights)
    sample_weights = [w / total for w in sample_weights]

    read_alloc = allocate_threads(traj_read_threads, np.asarray(sample_weights))
    xform_alloc = allocate_threads(traj_transform_threads, np.asarray(sample_weights))

    datasets = []
    for i, (kw, stats, n_read, n_xform) in enumerate(zip(dataset_kwargs_list, all_stats, read_alloc, xform_alloc)):
        trajs, _ = make_dataset_from_rlds(
            **kw, train=train, split=split, dataset_statistics=stats,
            num_parallel_reads=int(n_read), num_parallel_calls=int(n_xform), seed=[seed, i, 0],
        )
        datasets.append((trajs.repeated() if train else trajs, int(n_xform), [seed, i, 1]))

    def make_frames(index: int, count: int) -> Iterator[dict]:
        streams = [
            traj_transforms.flatten_to_frames(apply_trajectory_transforms(
                trajs, train=train, num_parallel_calls=n_xform, rng=np.random.default_rng(sub_seed),
                **traj_transform_kwargs,
            ))
            for trajs, n_xform, sub_seed in datasets
        ]
        if len(streams) == 1:
            frames = streams[0]
        else:
            frames = sample_from_datasets(streams, sample_weights, np.random.default_rng([seed, _SAMPLING]))
        if train and shuffle_buffer_size > 1:
            frames = shuffle_buffer(frames, shuffle_buffer_size, np.random.default_rng([seed, _FRAME_SHUFFLE]))
        if frame_transform_kwargs:
            return apply_frame_transforms(frames, train=train, seed=seed, shard=(index, count),
                                          **frame_transform_kwargs)
        return itertools.islice(frames, index, None, count)

    return FrameDataset(make_frames, batch_size, sample_weights, all_stats)


def allocate_threads(n: Optional[int], weights: np.ndarray) -> np.ndarray:
    """Integer thread split proportional to weights, minimum 1 each
    (reference data_utils.py:424-454)."""
    if n is None:
        return np.asarray([AUTOTUNE] * len(weights))
    weights = np.asarray(weights, np.float64)
    assert (weights >= 0).all() and len(weights) <= n
    weights = weights / weights.sum()
    alloc = np.zeros_like(weights, dtype=int)
    while True:
        mask = (weights * n < 1) & (weights > 0)
        if not mask.any():
            break
        n -= int(mask.sum())
        alloc += mask.astype(int)
        weights[mask] = 0
        weights = weights / weights.sum()
    frac, integral = np.modf(weights * n)
    alloc += integral.astype(int)
    n -= int(integral.sum())
    for i in np.argsort(frac)[::-1][:n]:
        alloc[i] += 1
    return alloc
