"""Interleaved RLDS dataset bound to the π0 training transform
configuration (counterpart of the JAX package's ``agents/dataset.py``;
reference src/agent/dataset.py:14-81): numpy frame batches for the
TrainAgent, from the port's TF-free pipeline (``data/``).

``iterator(batch_size)`` starts again from the seed at each call and
batches in a background thread (a prefetch of a few batches), so that the
next batch is made while the card runs an update. Frames reach the card
through the agent's ``to_device``. In a world of n processes, process i
reads every n-th frame from i (JAX's ``ds.shard(n, i)`` before ``batch``).
"""

from __future__ import annotations

import logging

from open_pi_zero_torch.data.oxe import make_oxe_dataset_kwargs_and_weights
from open_pi_zero_torch.data.pipeline import batch_frames, make_interleaved_dataset
from open_pi_zero_torch.data.streams import prefetch
from open_pi_zero_torch.parallel.mesh import process_index, world_size
from open_pi_zero_torch.utils.monitor import log_execution_time

log = logging.getLogger(__name__)

PREFETCH_BATCHES = 4

# the π0 recipe's augmentation (reference agent/dataset.py:38-69)
PRIMARY_AUGMENT_KWARGS = dict(
    random_resized_crop=dict(scale=[0.8, 1.0], ratio=[0.9, 1.1]),
    random_brightness=[0.1],
    random_contrast=[0.9, 1.1],
    random_saturation=[0.9, 1.1],
    random_hue=[0.05],
    augment_order=[
        "random_resized_crop",
        "random_brightness",
        "random_contrast",
        "random_saturation",
        "random_hue",
    ],
)
WRIST_AUGMENT_KWARGS = {k: v for k, v in PRIMARY_AUGMENT_KWARGS.items() if k != "random_resized_crop"}
WRIST_AUGMENT_KWARGS["augment_order"] = PRIMARY_AUGMENT_KWARGS["augment_order"][1:]


class RLDSInterleavedDataset:
    """config: the `data.train` / `data.val` block of a train YAML
    (configs/train/bridge.yaml). Iterate with `.iterator(batch_size)`."""

    @log_execution_time(log)
    def __init__(self, config, train: bool = True, seed: int = 0):
        kwargs_list, sample_weights = make_oxe_dataset_kwargs_and_weights(
            config.dataset_mix,
            config.data_path,
            load_proprio=bool(config.get("load_proprio", True)),
            load_camera_views=tuple(config.get("load_camera_views", ("primary",))),
        )
        resize = tuple(config.get("resize_size", (224, 224)))
        self.dataset = make_interleaved_dataset(
            kwargs_list,
            sample_weights,
            train=train,
            split=config.get("split") or None,
            shuffle_buffer_size=int(config.get("shuffle_buffer_size", 10_000)),
            batch_size=None,  # batched in iterator()
            balance_weights=True,
            traj_transform_kwargs=dict(
                window_size=int(config.get("window_size", 1)),
                action_horizon=int(config.get("action_horizon", 4)),
                subsample_length=100,
                skip_unlabeled=bool(config.get("skip_unlabeled", True)),
                # cross-FAMILY mixes zero-pad trailing dims to one width after
                # per-dataset normalization (traj_transforms.pad_actions_and_proprio)
                max_action_dim=int(config["max_action_dim"]) if config.get("max_action_dim") else None,
                max_proprio_dim=int(config["max_proprio_dim"]) if config.get("max_proprio_dim") else None,
            ),
            frame_transform_kwargs=dict(
                # `augment: false` disables train-time image augmentation
                image_augment_kwargs=(
                    {"primary": PRIMARY_AUGMENT_KWARGS, "wrist": WRIST_AUGMENT_KWARGS}
                    if train and bool(config.get("augment", True))
                    else None
                ),
                resize_size=dict(primary=resize, wrist=resize),
                num_parallel_calls=int(config.get("num_parallel_calls", 16)),
            ),
            traj_transform_threads=config.get("traj_transform_threads"),
            traj_read_threads=config.get("traj_read_threads"),
            seed=seed,
        )

    def iterator(self, batch_size: int, shard_per_process: bool = True):
        """Numpy frame batches from the start of the seeded stream; with
        ``shard_per_process``, of this process's shard of it (every n-th
        frame from its rank, n the world's processes), so that the global
        batch is disjoint across processes (reference train.py:142-156)."""
        shard = (process_index(), world_size()) if shard_per_process else (0, 1)
        return prefetch(batch_frames(self.dataset.frames(*shard), batch_size), PREFETCH_BATCHES)
