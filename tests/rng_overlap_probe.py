"""The Philox offsets that ``init_params(seed=0)`` takes on a card at the
reach geometry, and those one update's draws (flow times, noise) take from
a generator seeded alike (as the TrainAgent seeded it before
``training/seeds.py``) and from the train stream. Needs a card; imports
nothing of JAX:

  python -m tests.rng_overlap_probe
"""

import torch

from open_pi_zero_torch.config import ConfigDict, pizero_config_from_dict
from open_pi_zero_torch.models import pizero
from open_pi_zero_torch.scripts.demo_closed_loop import model_geometry
from open_pi_zero_torch.training import seeds
from open_pi_zero_torch.training.sampling import sample_flow_time


def main() -> None:
    cfg = pizero_config_from_dict(ConfigDict(model_geometry(96, 3)))
    gens = []
    real = pizero._Init.__init__

    def keep(self, *a, **k):
        real(self, *a, **k)
        gens.append(self.gen)

    pizero._Init.__init__ = keep
    try:
        pizero.init_params(cfg, seed=0, device="cuda")
    finally:
        pizero._Init.__init__ = real
    init_end = gens[0].get_offset()
    for name, g in (("seeded alike", torch.Generator("cuda").manual_seed(0)),
                    ("train stream", seeds.stream_generator(0, seeds.TRAIN, device="cuda"))):
        sample_flow_time(g, 32, cfg)
        torch.randn((32, 4, 7), generator=g, device="cuda")
        per_update = g.get_offset()
        shared = -(-init_end // per_update) if g.initial_seed() == 0 else 0
        print(f"philox: init_params(seed=0) takes offsets [0, {init_end}); {name} (seed {g.initial_seed()}): "
              f"{per_update} per update; updates whose counters the init used: {shared}")


if __name__ == "__main__":
    main()
