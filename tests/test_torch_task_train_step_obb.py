"""The port's obb train step against JAX's, two steps on the tiny config
at 64 px; see ``tests/test_torch_task_train_step.py`` for the batch, the
state and the tolerances."""

import pytest
import torch

from test_torch_task_train_step import (
    check_denominators,
    check_gradients,
    check_loss_items,
    run_task,
)

torch.set_num_threads(1)  # parallel test workers share the cores: more threads spin


@pytest.fixture(scope="module")
def runs():
    return run_task("obb")


def test_obb_denominators_clamp(runs):
    check_denominators(runs)


@pytest.mark.parametrize("step", [0, 1])
def test_obb_loss_items_match_jax(runs, step):
    check_loss_items(runs, step)


def test_obb_gradients_match_jax(runs):
    check_gradients(runs)
