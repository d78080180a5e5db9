"""The random streams of a training run, each derived from the run's seed.

``init_params(seed=seed)`` seeds its generator with the seed itself. A
generator seeded alike replays the init's numbers: on the CPU (MT19937)
the first updates' noise would be entries of the init's tables, on a card
(Philox) the first updates' flow times and noise would be elementwise
functions of init leaves. So every other stream of a run is seeded from
``stream_seed(seed, stream, *index)``: the first 64 bits of numpy's
``SeedSequence(seed, spawn_key=(stream, *index))``, a hash of the seed
and the stream's key (numpy's documented ``spawn`` derivation). Streams
with distinct keys are independent of each other and of the init's, for
any seed. On the CPU torch seeds MT19937 with the low 32 bits only; those
bits are drawn from the same hash.
"""

from __future__ import annotations

import numpy as np
import torch

# stream keys; 0 is left out: the init draws from the seed itself
TRAIN = 1  # the train state's generator: flow times and noise x0
VALIDATION = 2  # the validation generator, one per validating update (index)


def stream_seed(seed: int, stream: int, *index: int) -> int:
    """A 64-bit seed for the stream ``(stream, *index)`` of the run ``seed``."""
    if stream <= 0:
        raise ValueError(f"stream {stream}: keys start at 1 (the init draws from the seed itself)")
    state = np.random.SeedSequence(int(seed), spawn_key=(int(stream), *map(int, index))).generate_state(1, np.uint64)
    return int(state[0])


def stream_generator(seed: int, stream: int, *index: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded with ``stream_seed(seed, stream, *index)``."""
    return torch.Generator(device).manual_seed(stream_seed(seed, stream, *index))
