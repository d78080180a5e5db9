"""The three-family chains and the scale-up geometry end to end on the CPU:
``demo_closed_loop`` on ``--task tri_family`` and ``tri_lever`` (with
``--drawer-n-demos``), and on ``--task reach`` at the scale-up recipe's
8 query heads over 1 KV head of 32 (K1 unpadded), at the small
size of ``tests/test_torch_demo_scripts.py`` (4 demos, 4 updates of B = 4,
hidden 32, 1 layer, 1 episode per eval), then ``eval_scaleup_ckpt`` on each
scored leg of the final checkpoint (``tests/demo_chains.py`` says what each
chain must give), and the JAX package's closed loop on each leg of the same
export (``tests/demo_reference_inputs.py --jax-eval``). The results are
counts and rates; no tolerance applies.
"""

import pytest

from tests.demo_chains import check_jax_closed_loop, check_result, check_scored_legs, run_chain


@pytest.fixture(scope="module", params=["tri_family", "tri_lever", "scale_up"])
def chain(request, tmp_path_factory):
    work = tmp_path_factory.mktemp(request.param)
    return request.param, work, run_chain(request.param, work)


def test_chain_writes_trains_and_scores_each_leg(chain):
    check_result(*chain)


def test_eval_scaleup_scores_each_leg_of_the_checkpoint(chain):
    check_scored_legs(*chain)


def test_jax_closed_loop_scores_each_leg_of_the_export(chain):
    check_jax_closed_loop(*chain)
