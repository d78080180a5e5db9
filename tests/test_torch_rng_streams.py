"""The TrainAgent's random streams against its init's (``training/seeds.py``).

``init_params(seed=s)`` draws every leaf from a generator seeded with
``s``. The train state's generator (flow times t, noise x0) and the
validation generator must not replay those numbers, nor each other's. On
the CPU (MT19937) a replay is exact: seeded alike, the first updates' x0
are entries of the init's token-embedding table.

At the reach recipe's geometry (``demo_closed_loop.model_geometry(96, 3)``,
B = 32) for seeds 0-3 the test records:
  - the init's draws in standard form: ``init_params`` again with each
    leaf's ``uniform_(-b, b)`` / ``normal_(0, std)`` replaced by
    ``torch.rand`` / ``torch.randn`` on the same generator, which consume
    the same numbers (the generator's state after it equals the real
    init's);
  - the raw ``torch.rand`` / ``torch.randn`` draws of the agent's first 20
    updates (t's uniforms, x0) and of its validation at two updates.
A float32 draw meets one of the init's million values by chance in about
one case of a hundred, so a replay is judged by runs: two consecutive
draws equal to two consecutive init draws of the same kind (none by
chance in these sizes). Each stream shares no such run with the init or
with another stream, and its single-value matches stay at chance (under
5%; seeded alike they are 100%).
"""

import types

import numpy as np
import pytest
import torch

from open_pi_zero_torch.agents import train as t_agent
from open_pi_zero_torch.config import pizero_config_from_dict
from open_pi_zero_torch.models import pizero
from open_pi_zero_torch.scripts import demo_closed_loop as demo
from tests.test_torch_train_agent_card import Frames

N_UPDATES = 20
BATCH = 32
CHANCE_SHARE = 0.05


def reach_config(tmp_path, seed):
    args = types.SimpleNamespace(
        seed=seed, init_params=None, workdir=str(tmp_path), n_updates=N_UPDATES, save_freq=0,
        global_batch=BATCH, lr=1e-3, resume=False,
    )
    cfg = demo.train_config(args, demo.model_geometry(96, 3), "bridge", str(tmp_path / "rlds"), 1, False)
    cfg.eval_freq, cfg.eval_size = 0, BATCH
    return cfg


def init_draws(cfg, seed):
    """{"uniform", "normal"}: the init's draws in standard form, in order."""
    gens, draws = [], {"uniform": [], "normal": []}
    real_init = pizero._Init.__init__

    def keep(self, *a, **k):
        real_init(self, *a, **k)
        gens.append(self.gen)

    def uniform(self, shape, bound):
        u = torch.rand(shape, generator=self.gen, dtype=self.dtype)
        draws["uniform"].append(u.reshape(-1))
        return u * (2 * bound) - bound

    def normal(self, shape, std=1.0):
        z = torch.randn(shape, generator=self.gen, dtype=self.dtype)
        draws["normal"].append(z.reshape(-1))
        return z * std

    model_cfg = pizero_config_from_dict(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pizero._Init, "__init__", keep)
        pizero.init_params(model_cfg, seed=seed, device="cpu")  # the real draws
        mp.setattr(pizero._Init, "uniform", uniform)
        mp.setattr(pizero._Init, "normal", normal)
        pizero.init_params(model_cfg, seed=seed, device="cpu")  # their standard form
    real, replay = gens
    assert torch.equal(real.get_state(), replay.get_state()), "the replay consumed other numbers than the init"
    return {k: torch.cat(v).numpy() for k, v in draws.items()}


def agent_draws(cfg, monkeypatch):
    """{(stream, kind): draws}: the raw draws of the agent's first updates
    ("train") and of its validation at updates 1 and N ("validation")."""
    draws = {}
    stream = ["train"]
    real = {"uniform": torch.rand, "normal": torch.randn}

    def recording(kind):
        def draw(*a, generator=None, **k):
            x = real[kind](*a, generator=generator, **k)
            if generator is not None:
                draws.setdefault((stream[0], kind), []).append(x.detach().reshape(-1).clone())
            return x
        return draw

    monkeypatch.setattr(torch, "rand", recording("uniform"))
    monkeypatch.setattr(torch, "randn", recording("normal"))
    agent = t_agent.TrainAgent(cfg, dataset=Frames(0, size=56), device="cpu")
    agent.run()
    stream[0] = "validation"
    agent.val_dataset = Frames(1, size=56)
    for update in (1, N_UPDATES):
        assert agent.validate(update) is not None
    monkeypatch.undo()
    return {k: torch.cat(v).numpy() for k, v in draws.items()}


def pair_keys(x: np.ndarray) -> np.ndarray:
    """Each two consecutive float32 draws as one uint64 key."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return (bits[:-1] << np.uint64(32)) | bits[1:]


def shared_runs(a: np.ndarray, b: np.ndarray) -> int:
    """Positions of ``a`` where it and the next draw equal two consecutive
    draws of ``b``."""
    return int(np.isin(pair_keys(a), pair_keys(b)).sum())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_training_and_validation_draws_share_nothing_with_the_init(tmp_path, monkeypatch, seed):
    cfg = reach_config(tmp_path, seed)
    init = init_draws(cfg, seed)
    drawn = agent_draws(cfg, monkeypatch)
    # what the streams drew: 20 updates of t (Beta via 32 uniforms) and x0
    # [32, 4, 7]; validation's noise [32, 4, 7] at two updates
    assert drawn[("train", "uniform")].size == N_UPDATES * BATCH
    assert drawn[("train", "normal")].size == N_UPDATES * BATCH * 4 * 7
    assert drawn[("validation", "normal")].size == 2 * BATCH * 4 * 7
    for (stream, kind), x in drawn.items():
        assert shared_runs(x, init[kind]) == 0, f"{stream} {kind} replays the init's draws"
        assert np.isin(x, init[kind]).mean() < CHANCE_SHARE, f"{stream} {kind} meets the init's draws"
    train, val = drawn[("train", "normal")], drawn[("validation", "normal")]
    assert shared_runs(val, train) == 0 and shared_runs(train, val) == 0
    # the two validations draw from streams of their own as well
    half = val.size // 2
    assert shared_runs(val[:half], val[half:]) == 0


def test_stream_seeds_are_distinct_from_the_seeds_and_each_other():
    """For seeds 0-63, the train stream and the validation streams of
    updates 0-63 get seeds distinct from every run seed and from each
    other, in all 64 bits and in the low 32 that seed MT19937 on the CPU;
    the derivation is fixed (numpy's SeedSequence) and refuses stream 0."""
    from open_pi_zero_torch.training import seeds

    run_seeds = range(64)
    derived = [seeds.stream_seed(s, seeds.TRAIN) for s in run_seeds]
    derived += [seeds.stream_seed(s, seeds.VALIDATION, u) for s in run_seeds for u in range(64)]
    for values in (derived, [d & 0xFFFFFFFF for d in derived]):
        assert len(set(values)) == len(values)
        assert not set(values) & set(run_seeds)
    state = np.random.SeedSequence(7, spawn_key=(seeds.TRAIN,)).generate_state(1, np.uint64)
    assert seeds.stream_seed(7, seeds.TRAIN) == int(state[0])
    with pytest.raises(ValueError):
        seeds.stream_seed(0, 0)
    g = seeds.stream_generator(3, seeds.VALIDATION, 5)
    assert torch.equal(torch.rand(4, generator=g),
                       torch.rand(4, generator=torch.Generator().manual_seed(seeds.stream_seed(3, seeds.VALIDATION, 5))))
