"""In-repo kinematic environments for closed-loop evaluation (counterpart
of the JAX package's ``envs/``, numpy only).

SimplerEnv/SAPIEN is not installed where the port runs; these
environments speak the observation/step protocol the real Simpler tasks
do (reference src/agent/eval.py:60-179), so the whole EvalAgent +
env-adapter + policy stack runs in a closed loop and scores a success
rate, the reference's acceptance metric (reference README.md:90-114).
"""

from open_pi_zero_torch.envs.drawer_env import (  # noqa: F401
    DrawerEnv,
    collect_fractal_demos,
    drawer_expert,
    fractal_proprio_parts,
    register_drawer_lever_mix,
    write_fractal_demo_dataset,
)
from open_pi_zero_torch.envs.pick_place_env import (  # noqa: F401
    PickPlaceEnv,
    pick_place_expert,
)
from open_pi_zero_torch.envs.reach_env import (  # noqa: F401
    INSTRUCTIONS,
    ReachEnv,
    bridge_proprio,
    collect_demos,
    register_simpler_lite_mix,
    register_simpler_lite_tri_lever_mix,
    register_simpler_lite_tri_mix,
    scripted_expert,
    warm_tokenizer,
    write_demo_dataset,
)

# demo-collection registry: task -> env class, scripted expert, horizon
TASKS = {
    "reach": dict(env=ReachEnv, expert=scripted_expert, max_steps=60),
    "pick_place": dict(env=PickPlaceEnv, expert=pick_place_expert, max_steps=96),
}


def make_env(task: str, seed: int = 0):
    """Eval-config env factory (EvalAgent routes `simpler_lite*` tasks
    here; real Simpler task names go to simpler_env.make)."""
    if task == "simpler_lite_reach":
        return ReachEnv(seed=seed)
    if task == "simpler_lite_reach_multi":
        return ReachEnv(seed=seed, multi_subtask=True, max_steps=96)
    if task == "simpler_lite_pick_place":
        return PickPlaceEnv(seed=seed)
    if task == "simpler_lite_drawer":
        return DrawerEnv(seed=seed)
    if task.startswith("simpler_lite_drawer_"):
        # single-target variants for per-target data-efficiency runs;
        # layouts per episode_id match the unrestricted env
        return DrawerEnv(seed=seed, target=task.rsplit("_", 1)[-1])
    raise ValueError(
        f"unknown simpler_lite task {task!r}; known: simpler_lite_reach, "
        "simpler_lite_reach_multi, simpler_lite_pick_place, simpler_lite_drawer"
        " (optionally suffixed _top/_middle/_bottom)"
    )
