"""``tests/test_torch_demo_lockstep.py``'s check at the scale-up recipe's
geometry (hidden 256, 6 layers, 8 query heads over 1 KV head of 32): the
port's ``TrainAgent.run`` against the JAX package's, update by update, on
``reach`` (its script's config at the lockstep's updates and batch, JAX's
init, JAX's batches and draws), under the same tolerances.

Why this geometry too: it is the one at which the port's run and JAX's part
most (``E2E_CLOSED_LOOP_TORCH.json``, ``scale_up_reach_8k``: the port's
loss ends far below JAX's plateau), so the update is cleared there, not
only at the demonstration's 4 heads of 24. A file of its own, so that
``--dist loadfile`` runs it on another worker and each file stays under a
minute alone.
"""

from tests.test_torch_demo_drawer import restore_registries  # noqa: F401
from tests.test_torch_demo_lockstep import SCALE_UP, check_lockstep


def test_scale_up_train_agent_run_is_jax_s_update_by_update(tmp_path, monkeypatch, restore_registries):
    check_lockstep("reach", SCALE_UP, tmp_path, monkeypatch)
